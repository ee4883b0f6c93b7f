"""Haplotype-combination (hidden state) enumeration.

Port of reference GENOTYPE::increment_vector (src/genotype.cpp:835-919):
  * diploid het: all multisets of size samplePloidy drawn from the (sorted)
    topHapVec -- enumerated in the reference's exact order, which posterior
    tie-breaking depends on
  * hom: homozygous combinations only
  * polyploid (>2): each haplotype expands to its sample's own haplotype
    group, deduplicated and sorted
"""

from __future__ import annotations

import math


def increment_vector(
    hap_vec: list[int],
    sample_type: str,
    sample_ploidy: int,
    max_hap_idx: int,
) -> list[list[int]]:
    com_hap_vec: list[list[int]] = []

    # ---------------- polyploidy (samplePloidy > 2) ----------------
    if sample_ploidy > 2:
        for hap in hap_vec:
            if hap == 0:
                tmp = [0] * sample_ploidy
            else:
                quotient = math.ceil(hap / float(sample_ploidy))
                first = (quotient - 1) * sample_ploidy + 1
                tmp = list(range(first, first + sample_ploidy))
                tmp = [0 if v > max_hap_idx else v for v in tmp]
            com_hap_vec.append(tmp)
        # sort + dedup (std::set of vectors -> lexicographic order)
        dedup = sorted({tuple(v) for v in com_hap_vec})
        return [list(v) for v in dedup]

    # ---------------- diploid ----------------
    hap_num = len(hap_vec) - 1
    idx_vecs: list[list[int]] = []
    for hap_idx in range(len(hap_vec)):
        vec = [hap_idx] * sample_ploidy
        idx_vecs.append(list(vec))
        if sample_type == "hom":
            continue
        min_el = min(vec[1:])
        while min_el < hap_num:
            index = len(vec) - 1
            while vec[index] == hap_num:
                vec[index] = min_el + 1
                index -= 1
            vec[index] += 1
            idx_vecs.append(list(vec))
            min_el = min(vec[1:])

    return [[hap_vec[i] for i in idx] for idx in idx_vecs]
