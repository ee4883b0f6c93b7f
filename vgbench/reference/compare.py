"""The numbers that decide ``correct``, each the gap between what the port
produced and what the reference works out.

A genotyped VCF carries GT, GQ and GPP with one decimal, and NAK and CAK of
the winning state's haplotypes.  When two states of the winning genotype
tie (their haplotypes hold the same k-mers), which one wins, and so the
phase of GT and the order of NAK and CAK, rests on rounding.  So a site's
genotype is compared unphased and its NAK/CAK as pairs in sorted order.
GPP (the winning genotype's posterior, summed over its states) does not
rest on the tie, and is compared as the VCF prints it.  GQ is compared
as printed too, with both sides held to upstream's cap of 99 (``phred``):
above it 1 - GPP is under 1.3e-10, where the phred of a posterior computed
in float64 is rounding (the port prints 159.5 where the reference works out
151.7 at the same site, both from 1 - GPP of ~1e-16).  Below the cap GQ
magnifies the float32 chains' rounding in 1 - GPP, and a site whose GQ lies
within that of a printed decimal's edge prints 0.1 apart on the two sides;
so GQ is held to the widest gap between the printed values (``gq_gap``),
not to a count of sites that differ at all.
"""

from __future__ import annotations

import math

import numpy as np

GQ_CAP = 99.0


def phred(p: float) -> float:
    """GQ of a posterior: -10 log10(1 - p), 99 at p >= 1 (upstream
    genotype.cpp:1559-1561)."""
    return GQ_CAP if p >= 1.0 else -10.0 * math.log10(1.0 - p)


def _unphased(gt: str) -> tuple:
    return tuple(sorted(gt.split("/")))


def _gq(rec: tuple) -> float:
    """GQ capped at GQ_CAP: the VCF's own where the record carries one (a
    sixth field), else worked out from its GPP."""
    return min(rec[5] if len(rec) > 5 else phred(rec[1]), GQ_CAP)


def call_gaps(want: dict, got: dict) -> dict:
    """want: {start: (GT, GPP, NAK, CAK, UK)} from the reference; got: the
    same from a VCF (with GQ as a sixth field) or from a lower-precision
    reference.  Returns call_diff (sites whose unphased GT differs, or that
    only one side writes), and of the sites of equal GT: kmer_diff (NAK/CAK
    pairs or UK differ), gpp_diff (GPP differs at the printed decimal) and
    gq_gap (the widest gap between the two GQs, capped at 99, as printed),
    with gq_site, (start, reference GQ unrounded, other GQ) at that gap."""
    out = {"call_diff": 0, "kmer_diff": 0, "gpp_diff": 0, "gq_gap": 0.0,
           "gq_site": None}
    for s in sorted(set(want) | set(got)):
        a, b = want.get(s), got.get(s)
        if a is None or b is None or _unphased(a[0]) != _unphased(b[0]):
            out["call_diff"] += 1
            continue
        pa = sorted(zip(a[2], (f"{x:.1f}" for x in a[3])))
        pb = sorted(zip(b[2], (f"{x:.1f}" for x in b[3])))
        out["kmer_diff"] += pa != pb or a[4] != b[4]
        out["gpp_diff"] += f"{a[1]:.1f}" != f"{b[1]:.1f}"
        ga, gb = _gq(a), _gq(b)
        gap = round(abs(float(f"{ga:.1f}") - float(f"{gb:.1f}")), 1)
        if gap > out["gq_gap"]:
            out["gq_gap"], out["gq_site"] = gap, (s, ga, gb)
    return out


def table_diff(prog: dict, ref) -> int:
    """Rows of the port's table, or entries of its nodes' k-mer lists, that
    differ from the reference's (the count of the first array that differs
    in length counts whole)."""
    pairs = [("keys", ref.keys), ("freq", ref.freq), ("flag", ref.flag),
             ("bits", ref.bits), ("node_start", ref.node_start),
             ("tbl_off", ref.tbl_off), ("tbl_idx", ref.tbl_idx),
             ("tbl_lp", ref.tbl_lp)]
    diff = 0
    for name, want in pairs:
        got = prog[name]
        if name in ("bits", "tbl_lp"):
            got = got[:, : want.shape[1]]
        if got.shape != want.shape:
            diff += max(len(got), len(want))
        else:
            d = got != want
            diff += int(d.reshape(len(d), -1).any(axis=1).sum()) if d.ndim > 1 else int(d.sum())
    return diff


def count_diff(prog_cov: np.ndarray, ref_cov: np.ndarray) -> int:
    if prog_cov.shape != ref_cov.shape:
        return max(len(prog_cov), len(ref_cov))
    return int((prog_cov.astype(np.int64) != ref_cov).sum())


def chain_gaps(want: list, logE: np.ndarray, alpha: np.ndarray,
               beta: np.ndarray) -> dict:
    """The emissions and the forward/backward of each window against the
    reference's (``genotype.call_sites``' chains): emit_gap, the largest
    |logE - reference| / max(1, |reference|), and chain_gap, the largest
    |alpha - reference| or |beta - reference|.  The port pads windows to
    one [windows, nodes, states] group; a shape that does not fit, or -inf
    at other places, reads inf."""
    if logE.shape[0] != len(want):
        return {"emit_gap": math.inf, "chain_gap": math.inf}
    eg = cg = 0.0
    for w, (le, a, b) in enumerate(want):
        n, s = le.shape
        if n > logE.shape[1] or s > logE.shape[2]:
            return {"emit_gap": math.inf, "chain_gap": math.inf}
        pe = logE[w, :n, :s].astype(np.float64)
        fin = np.isfinite(le)
        if not np.array_equal(fin, np.isfinite(pe)):
            return {"emit_gap": math.inf, "chain_gap": math.inf}
        if fin.any():
            eg = max(eg, float((np.abs(pe - le)[fin] / np.maximum(1.0, np.abs(le[fin]))).max()))
        cg = max(cg, float(np.abs(alpha[w, :n, :s] - a).max()),
                 float(np.abs(beta[w, :n, :s] - b).max()))
    return {"emit_gap": eg, "chain_gap": cg}
