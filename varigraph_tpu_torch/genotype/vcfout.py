"""Genotyped VCF writer (reference GENOTYPE::save, src/genotype.cpp:1579-1696).

Output columns: original cols 0-7 with FILTER forced to PASS, FORMAT
GT:GQ:GPP:NAK:CAK:UK, then the sample column.  Floats are printed with one
decimal (the reference's `fixed << setprecision(1)` stream state)."""

from __future__ import annotations

import math

from ..index.structs import GraphIndex
from ..io.gzout import GzWriter
from ..utils.log import log
from .engine_np import PosteriorRecord


def cal_phred_scaled(value: float) -> float:
    """GQ = -10*log10(1-GPP), 99 if GPP>=1 (genotype.cpp:1559-1561)."""
    return 99.0 if value >= 1.0 else -10.0 * math.log10(1.0 - value)


def write_vcf(
    gi: GraphIndex,
    results: dict[tuple[str, int], PosteriorRecord],
    sample_name: str,
    out_path: str,
    min_supporting_gq: float,
) -> None:
    log(f"Wrote genotyped variants to '{out_path}'", func="save")
    with GzWriter(out_path) as w:
        w.write(gi.vcf_head + "\t" + sample_name + "\n")
        node_by_pos = {
            (chrom, n.start): n
            for chrom in gi.graph.nodes
            for n in gi.graph.nodes[chrom]
        }
        for chrom in sorted(gi.vcf_info.keys()):
            if chrom not in gi.graph.nodes:
                continue
            for start in sorted(gi.vcf_info[chrom].keys()):
                info = gi.vcf_info[chrom][start]
                node = node_by_pos.get((chrom, start))
                if node is None:
                    continue
                rec = results.get((chrom, start))
                if rec is None or not rec.hap_vec:
                    continue
                hap_gt = node.hap_gt
                gt_txt = [str(hap_gt[h]) for h in rec.hap_vec]
                if all(g in ("0", ".") for g in gt_txt):
                    continue

                cols = list(info[:8])
                cols[6] = "PASS"
                gq = cal_phred_scaled(rec.probability)
                if gq < min_supporting_gq:
                    gt_txt = ["."] * len(gt_txt)
                fields = [
                    "/".join(gt_txt),
                    f"{gq:.1f}",
                    f"{rec.probability:.1f}",
                    ",".join(str(n) for n in rec.kmer_num_vec),
                    ",".join(f"{v:.1f}" for v in rec.kmer_avecov_vec),
                    str(rec.uk),
                ]
                w.write(
                    "\t".join(cols)
                    + "\tGT:GQ:GPP:NAK:CAK:UK\t"
                    + ":".join(fields)
                    + "\n"
                )
