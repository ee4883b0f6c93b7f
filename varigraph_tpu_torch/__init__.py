"""varigraph-tpu on PyTorch and CUDA: construct and genotype on one device.

A port of the JAX package ``varigraph_tpu`` (which stays in the repository as
the reference it is tested against) to PyTorch, with the counting join and
the counting Bloom filter written by hand in CUDA for Hopper (sm_90a).  This package imports ``torch``
and never ``jax``: the host-only numpy code it shares with the JAX package is
copied, because importing any ``varigraph_tpu`` module imports jax.

Ported so far, on one device:
  ``construct -r ref.fa -v vars.vcf.gz --save-graph G.vgt``:
  io/fasta.read_fasta -> index/graph.build_graph_from_vcf -> host context
  walk -> genome counts (sketch in torch, the Bloom filter in
  ``csrc/cbf.cu``, or above 2^31 cells an exact count through
  ``csrc/join.cu``) -> context sketch, aggregation -> graph2node ->
  index/serialize.save_graph, driven by index/build.construct_graph_index;
  ``genotype --load-graph G.vgt``:
  index/serialize.load_graph -> genotype/counting.count_reads (sketch in
  torch, join in ``csrc/join.cu``) -> genotype/coverage.estimate_hap_coverage
  -> genotype/engine_torch.genotype_torch -> genotype/vcfout.write_vcf,
  driven by genotype/pipeline.run_genotype.

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
