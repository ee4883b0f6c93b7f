"""The graph index: everything the genotype phase needs, with the table's
keys and coverage as torch tensors on the run's device."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.table import KmerTable
from .graph import GenomeGraph, VariantStats


@dataclass
class GraphIndex:
    kmer_len: int
    vcf_ploidy: int
    graph_base_num: int
    genome_size: int
    hap_names: list[str]                      # index 0 = "reference"
    chrom_lens: dict[str, int]
    vcf_head: str
    vcf_info: dict[str, dict[int, list[str]]]
    graph: GenomeGraph                        # host node data (seqs, GTs, kmers)
    table: KmerTable                          # k-mer table (keys/cov on device)
    stats: VariantStats = field(default_factory=VariantStats)
    # the genotype window prep's copies of the table and the CSR on the
    # table's device (``ops/prep.PrepTables``), made at the first genotype
    prep_tables: object = field(default=None, repr=False)

    @property
    def nhap(self) -> int:
        return len(self.hap_names)

    def variant_nodes(self, chrom: str):
        """(index, Node) pairs for variant nodes of a chromosome, in order."""
        return [
            (i, n) for i, n in enumerate(self.graph.nodes[chrom]) if n.is_variant
        ]

    def hap_sample_name(self, hap_idx: int) -> str:
        return self.hap_names[hap_idx]
