"""Haplotype pre-selection via Dirichlet sampling.

Port of reference HaplotypeSelect (src/haplotype_select.cpp) +
GENOTYPE::haplotype_selection (src/genotype.cpp:519-594), with deterministic
seeding (the reference seeds mt19937 from random_device).

Per window: each haplotype's k-mer mass = sum of coverage over window k-mers
with c > 1 and f == 1 that the haplotype carries; a Gamma(count+1, 1) draw
per nonzero haplotype approximates a Dirichlet; the top `haploid_num`
haplotypes are kept with normalized scores.
"""

from __future__ import annotations

import numpy as np


def dirichlet_top_haps(
    hap_kmer_counts: np.ndarray,  # [H] uint k-mer mass per haplotype
    haploid_num: int,
    rng: np.random.Generator,
) -> tuple[list[int], dict[int, float]]:
    """Returns (top hap indices, hapIdx -> normalized score)."""
    h = len(hap_kmer_counts)
    freq = np.zeros(h, dtype=np.float64)
    nz = np.nonzero(hap_kmer_counts)[0]
    for i in nz:
        freq[i] = rng.gamma(shape=float(hap_kmer_counts[i]) + 1.0, scale=1.0)
    s = freq.sum()
    if s > 0:
        freq = freq / s

    n = min(haploid_num, h)
    # top-n by frequency; ties broken toward lower hap index (deterministic;
    # the reference's heap order for ties is implementation-defined)
    order = np.lexsort((np.arange(h), -freq))
    top = order[:n]
    total = freq[top].sum()
    score_map = {
        int(i): (float(freq[i]) / total if total > 0 else float("nan")) for i in top
    }
    return sorted(int(i) for i in top), score_map


def window_hap_counts(
    node_kmer_idx_list: list[np.ndarray],
    cov_u8: np.ndarray,
    freq: np.ndarray,
    hap_words: np.ndarray,   # [M, W] packed uint32 haplotype bits
    nhap: int,
) -> np.ndarray:
    """Per-haplotype k-mer mass over a window's node k-mers
    (genotype.cpp:536-572: only k-mers with c > 1 and f == 1 count).

    Haplotype bits stay packed globally; only the window's selected rows
    (bounded by nodes-per-window x 128) are gathered and unpacked."""
    from ..ops.table import unpack_hapbits

    counts = np.zeros(nhap, dtype=np.uint64)
    if not node_kmer_idx_list:
        return counts
    idx = np.concatenate(
        [np.asarray(a, np.int64) for a in node_kmer_idx_list if len(a)]
        or [np.empty(0, np.int64)]
    )
    if not len(idx):
        return counts
    c = cov_u8[idx]
    keep = (c > 1) & (freq[idx] == 1)
    if not keep.any():
        return counts
    sel = idx[keep]
    rows = unpack_hapbits(hap_words[sel], nhap).astype(np.uint64)
    counts += (rows * c[keep, None].astype(np.uint64)).sum(axis=0)
    return counts
