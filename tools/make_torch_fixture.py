"""Write the committed test graph used by the torch port's smoke run.

Builds the bench's "small" dataset (bench.py: one 2 Mb chromosome, 2,000
variants, samples S1 and S2, data seed 123) and constructs its graph with the
JAX package on the CPU (k = 27, construct seed 0).  Writes

  tests/fixtures/slice2m/ref.fa.gz     the reference
  tests/fixtures/slice2m/vars.vcf.gz   the population VCF (truth for S1)
  tests/fixtures/slice2m/graph.vgt     the saved graph

Reads are not written: chip_smoke.py simulates them from S1's haplotypes.
Run from the repository root:

  JAX_PLATFORMS=cpu python tools/make_torch_fixture.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

OUT = os.path.join(ROOT, "tests", "fixtures", "slice2m")
SEED = 123
CHROM_LENS = {"chr1": 2_000_000}
N_VARIANTS = 2000
SAMPLES = ("S1", "S2")
K = 27


def main() -> None:
    from data_gen import make_genome, make_vcf, write_fasta, write_vcf

    from varigraph_tpu.config import VarigraphConfig
    from varigraph_tpu.index.build import construct_graph_index
    from varigraph_tpu.index.serialize import save_graph

    os.makedirs(OUT, exist_ok=True)
    # the same draws, in the same order, as data_gen.generate_dataset
    rng = np.random.default_rng(SEED)
    genome = make_genome(rng, CHROM_LENS)
    vcf_text, _ = make_vcf(genome, rng, n_variants_per_chrom=N_VARIANTS,
                           samples=SAMPLES)
    ref = os.path.join(OUT, "ref.fa.gz")
    vcf = os.path.join(OUT, "vars.vcf.gz")
    write_fasta(ref, genome)
    write_vcf(vcf, vcf_text)
    cfg = VarigraphConfig(ref_file=ref, vcf_file=vcf, kmer_len=K, seed=0)
    gi = construct_graph_index(cfg)
    save_graph(gi, os.path.join(OUT, "graph.vgt"))
    print(f"wrote {OUT}: {gi.table.size} table keys, {gi.nhap} haplotypes")


if __name__ == "__main__":
    main()
