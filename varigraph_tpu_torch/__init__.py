"""varigraph-tpu on PyTorch and CUDA: the genotype phase from a saved graph.

A port of the JAX package ``varigraph_tpu`` (which stays in the repository as
the reference it is tested against) to PyTorch, with the read-counting join
written by hand in CUDA for Hopper (sm_90a).  This package imports ``torch``
and never ``jax``: the host-only numpy code it shares with the JAX package is
copied, because importing any ``varigraph_tpu`` module imports jax.

Slice ported so far -- ``genotype --load-graph G.vgt``:
  index/serialize.load_graph -> genotype/counting.count_reads (sketch in
  torch, join in ``csrc/join.cu``) -> genotype/coverage.estimate_hap_coverage
  -> genotype/engine_torch.genotype_torch -> genotype/vcfout.write_vcf,
  driven by genotype/pipeline.run_genotype.

Graphs are still built by ``python -m varigraph_tpu construct``.

Integer conventions: k-mer encodings are uint64 values carried as int64 bit
patterns (torch on the CPU has no uint64 shifts, comparisons or search).
Any sort or search maps the order first (``x ^ (1 << 63)``), because at
k = 28 the encoding sets bit 63.
"""

import os

__version__ = "0.1.0"

# where kernels and native helpers are compiled at first use (git-ignored)
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "torch_kernels",
)
