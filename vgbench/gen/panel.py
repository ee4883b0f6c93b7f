"""Synthetic population panels, samples and sequencing reads, in numpy.

Grown from the repository's ``tools/gen_big.py`` (vectorized genome, sorted
non-overlapping sites, splicing of alleles, FASTQ records composed as byte
matrices through gzip level 1) and ``tests/data_gen.py`` (small VCF panels),
and extended with what a deployment's panel has: a site type mix of SNVs,
indels and structural variants, haplotypes that share blocks (so sites are
in linkage, as in a real panel), any ploidy, a sample from outside the panel
(a mosaic of panel haplotypes with private SNVs) and reads with substitution
errors.

Everything is drawn from one ``numpy`` generator: a configuration's
``data_seed`` fixes its panel, a run's ``--seed`` its samples and reads.  No
base is ambiguous: genome, alleles and reads hold only A, C, G and T.
"""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMP[_a] = _b
# the base that is not the given one, for an offset 1..3
_OTHER = np.zeros((256, 4), np.uint8)
for _a in b"ACGT":
    _i = b"ACGT".index(_a)
    for _o in range(4):
        _OTHER[_a, _o] = b"ACGT"[(_i + _o) % 4]

CHROM = "chr1"
SITE_MARGIN = 2_000   # bases kept free of sites at each end of the region


@dataclass
class Panel:
    genome: np.ndarray          # uint8 ASCII, the region's reference
    pos: np.ndarray             # int64 [n] 1-based site starts, sorted
    ref_len: np.ndarray         # int64 [n]
    alts: list[bytes]           # [n] ALT allele (anchor base first for indels)
    gt: np.ndarray              # uint8 [n, H] allele of panel haplotype h
    ploidy: int

    @property
    def nhap(self) -> int:
        return self.gt.shape[1]

    @property
    def nsample(self) -> int:
        return self.nhap // self.ploidy

    def ref_allele(self, i: int) -> bytes:
        p = int(self.pos[i]) - 1
        return self.genome[p : p + int(self.ref_len[i])].tobytes()


def _lengths(rng, n: int, lo: int, hi: int, kind: str) -> np.ndarray:
    """n lengths in [lo, hi]: geometric (short ones most common) or log-uniform."""
    if n == 0:
        return np.zeros(0, np.int64)
    if kind == "geometric":
        out = lo + rng.geometric(0.35, size=n) - 1
    else:
        out = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
    return np.clip(out.astype(np.int64), lo, hi)


def make_panel(cfg: dict) -> Panel:
    """The configuration's panel, from its ``data_seed``."""
    p = cfg["panel"]
    rng = np.random.default_rng(int(cfg["data_seed"]))
    glen = int(round(float(cfg["genome_mb"]) * 1_000_000))
    genome = BASES[rng.integers(0, 4, size=glen)]
    ploidy = int(p["ploidy"])
    nhap = int(p["samples"]) * ploidy

    # site types and lengths
    n_max = glen // int(p["site_spacing_bp"]) + 16
    mix = p["mix"]
    u = rng.random(n_max)
    is_indel = (u >= mix["snv"]) & (u < mix["snv"] + mix["indel"])
    is_sv = u >= mix["snv"] + mix["indel"]
    ins = rng.random(n_max) < 0.5
    ref_len = np.ones(n_max, np.int64)
    alt_len = np.ones(n_max, np.int64)
    ilen = _lengths(rng, n_max, 1, int(p["indel_max_bp"]) - 1, "geometric")
    svlen = _lengths(rng, n_max, int(p["sv_min_bp"]), int(p["sv_max_bp"]),
                     "loguniform")
    size = np.where(is_indel, ilen, np.where(is_sv, svlen, 0))
    alt_len = np.where((is_indel | is_sv) & ins, 1 + size, alt_len)
    ref_len = np.where((is_indel | is_sv) & ~ins, 1 + size, ref_len)

    # positions: at least one reference base between sites, mean spacing as
    # configured, sites inside [SITE_MARGIN, glen - SITE_MARGIN)
    mean_gap = max(float(p["site_spacing_bp"]) - float(ref_len.mean()), 2.0)
    gaps = rng.geometric(1.0 / mean_gap, size=n_max).astype(np.int64)
    starts = SITE_MARGIN + np.cumsum(gaps) + np.concatenate(
        [[0], np.cumsum(ref_len[:-1])])
    keep = starts + ref_len < glen - SITE_MARGIN
    n = int(keep.sum())
    pos = starts[:n] + 1
    ref_len, alt_len = ref_len[:n], alt_len[:n]

    # ALT alleles: a SNV takes another base; an insertion keeps the anchor
    # base and adds random ones; a deletion keeps the anchor base alone
    first = genome[pos - 1]
    snv = (ref_len == 1) & (alt_len == 1)
    off = rng.integers(1, 4, size=n)
    tail_all = BASES[rng.integers(0, 4, size=int(alt_len.sum()))]
    ends = np.cumsum(alt_len)
    alts = []
    for i in range(n):
        if snv[i]:
            alts.append(bytes([_OTHER[first[i], off[i]]]))
        elif alt_len[i] > 1:
            a = tail_all[ends[i] - alt_len[i] : ends[i]].copy()
            a[0] = first[i]
            alts.append(a.tobytes())
        else:
            alts.append(bytes([first[i]]))

    gt = panel_genotypes(rng, n, nhap, p)
    return Panel(genome=genome, pos=pos, ref_len=ref_len, alts=alts, gt=gt,
                 ploidy=ploidy)


def save_panel(panel: Panel, path: str) -> None:
    """The panel as one .npz (ALT alleles as one byte buffer and offsets)."""
    lens = np.array([len(a) for a in panel.alts], np.int64)
    np.savez(path, genome=panel.genome, pos=panel.pos, ref_len=panel.ref_len,
             alt_bytes=np.frombuffer(b"".join(panel.alts), np.uint8),
             alt_off=np.concatenate([[0], np.cumsum(lens)]), gt=panel.gt,
             ploidy=np.int64(panel.ploidy))


def load_panel(path: str) -> Panel:
    with np.load(path) as z:
        buf, off = z["alt_bytes"].tobytes(), z["alt_off"]
        return Panel(genome=z["genome"], pos=z["pos"], ref_len=z["ref_len"],
                     alts=[buf[a:b] for a, b in zip(off[:-1], off[1:])],
                     gt=z["gt"], ploidy=int(z["ploidy"]))


def panel_genotypes(rng, n: int, nhap: int, p: dict) -> np.ndarray:
    """[n, nhap] 0/1 alleles with linkage: every panel haplotype copies one
    of ``founders`` founder haplotypes in blocks of about ``block_sites``
    sites, and flips an allele at rate ``flip``.  Founder alleles follow a
    site's allele frequency, drawn from a distribution skewed to rare ones."""
    F = int(p["founders"])
    af = np.clip(rng.beta(0.45, 1.3, size=n), 0.02, 0.98)
    founders = (rng.random((n, F)) < af[:, None]).astype(np.uint8)
    gt = np.empty((n, nhap), np.uint8)
    block = float(p["block_sites"])
    for h in range(nhap):
        src = _blocks(rng, n, block, F)
        gt[:, h] = founders[np.arange(n), src]
    flips = rng.random((n, nhap)) < float(p["flip"])
    gt ^= flips.astype(np.uint8)
    return gt


def _blocks(rng, n: int, mean_len: float, choices: int, lo: int = 0) -> np.ndarray:
    """[n] source index per site: runs of mean length ``mean_len`` sites,
    each run a uniform draw from lo .. lo + choices - 1."""
    nb = max(2, int(n / mean_len * 3) + 2)
    lens = rng.geometric(1.0 / mean_len, size=nb)
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.geometric(1.0 / mean_len, size=nb)])
    src = lo + rng.integers(0, choices, size=len(lens))
    return np.repeat(src, lens)[:n]


def write_panel(panel: Panel, out_dir: str) -> tuple[str, str]:
    """ref.fa and vars.vcf.gz (phased GTs, one column a sample)."""
    os.makedirs(out_dir, exist_ok=True)
    fa = os.path.join(out_dir, "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(f">{CHROM}\n".encode())
        g = panel.genome.tobytes()
        for j in range(0, len(g), 60):
            fh.write(g[j : j + 60] + b"\n")
    vcf = os.path.join(out_dir, "vars.vcf.gz")
    P = panel.ploidy
    names = [f"P{s + 1:03d}" for s in range(panel.nsample)]
    # one GT column per sample: "a|b|..." from the [n, H] matrix at once
    digits = (panel.gt + ord("0")).astype(np.uint8)
    cols = np.full((panel.gt.shape[0], panel.nsample, 2 * P), ord("\t"), np.uint8)
    cols[:, :, 0 : 2 * P : 2] = digits.reshape(-1, panel.nsample, P)
    cols[:, :, 1 : 2 * P - 1 : 2] = ord("|")
    gt_text = cols.reshape(panel.gt.shape[0], -1)[:, :-1]
    with gzip.open(vcf, "wb", compresslevel=1) as fh:
        fh.write(b"##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={CHROM},length={len(panel.genome)}>\n".encode())
        fh.write(b'##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fh.write(("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(names) + "\n").encode())
        lines = []
        for i in range(len(panel.pos)):
            lines.append(b"%s\t%d\t.\t%s\t%s\t30\tPASS\t.\tGT\t%s\n" % (
                CHROM.encode(), int(panel.pos[i]), panel.ref_allele(i),
                panel.alts[i], gt_text[i].tobytes()))
            if len(lines) >= 4096:
                fh.write(b"".join(lines))
                lines = []
        fh.write(b"".join(lines))
    return fa, vcf


def haplotype_sequence(panel: Panel, alleles: np.ndarray,
                       genome: np.ndarray | None = None) -> np.ndarray:
    """The region as a haplotype carrying ``alleles`` ([n] 0/1) sees it."""
    genome = panel.genome if genome is None else genome
    parts = []
    cur = 0
    for i in np.flatnonzero(alleles):
        p = int(panel.pos[i]) - 1
        parts.append(genome[cur:p])
        parts.append(np.frombuffer(panel.alts[i], np.uint8))
        cur = p + int(panel.ref_len[i])
    parts.append(genome[cur:])
    return np.concatenate(parts)


def make_sample(panel: Panel, rng, traffic: dict) -> list[np.ndarray]:
    """A new individual of the panel's ploidy: each haplotype a mosaic of
    panel haplotypes in blocks of about ``mosaic_block_sites`` sites, over a
    reference that carries private SNVs at ``private_snv_rate`` a base (away
    from panel sites).  Returns the haplotype sequences."""
    n = len(panel.pos)
    genome = panel.genome.copy()
    glen = len(genome)
    covered = np.zeros(glen + 1, np.int64)
    np.add.at(covered, panel.pos - 1, 1)
    np.add.at(covered, panel.pos - 1 + panel.ref_len, -1)
    in_site = np.cumsum(covered)[:glen] > 0
    n_priv = rng.binomial(glen, float(traffic["private_snv_rate"]))
    at = rng.integers(0, glen, size=n_priv)
    at = at[~in_site[at]]
    genome[at] = _OTHER[genome[at], rng.integers(1, 4, size=len(at))]
    haps = []
    for _ in range(panel.ploidy):
        src = _blocks(rng, n, float(traffic["mosaic_block_sites"]), panel.nhap)
        haps.append(haplotype_sequence(panel, panel.gt[np.arange(n), src],
                                       genome))
    return haps


def _fastq_records(reads: np.ndarray, first_id: int) -> bytes:
    m, L = reads.shape
    rec_len = 11 + L + 1 + 2 + L + 1
    buf = np.empty((m, rec_len), np.uint8)
    ids = np.arange(first_id, first_id + m)
    buf[:, 0] = ord("@")
    buf[:, 1] = ord("r")
    for d in range(8):
        buf[:, 2 + d] = (ids // 10 ** (7 - d)) % 10 + ord("0")
    buf[:, 10] = ord("\n")
    buf[:, 11 : 11 + L] = reads
    o = 11 + L
    buf[:, o] = ord("\n")
    buf[:, o + 1] = ord("+")
    buf[:, o + 2] = ord("\n")
    buf[:, o + 3 : o + 3 + L] = ord("I")
    buf[:, o + 3 + L] = ord("\n")
    return buf.tobytes()


def simulate_reads(haps: list[np.ndarray], genome_len: int, rng,
                   traffic: dict) -> np.ndarray:
    """[R, read_len] uint8 reads: ``depth`` x the region in all, the same
    number from each haplotype (so every seed makes the same amount of
    work), uniform starts, half reverse-complemented, substitutions at
    ``error_rate`` a base."""
    L = int(traffic["read_len"])
    per_hap = int(round(genome_len * float(traffic["depth"]) / len(haps) / L))
    out = []
    for hs in haps:
        starts = rng.integers(0, len(hs) - L, size=per_hap)
        reads = hs[starts[:, None] + np.arange(L)]
        rc = rng.random(per_hap) < 0.5
        reads[rc] = COMP[reads[rc][:, ::-1]]
        err = rng.random(reads.shape) < float(traffic["error_rate"])
        reads[err] = _OTHER[reads[err], rng.integers(1, 4, size=int(err.sum()))]
        out.append(reads)
    reads = np.concatenate(out)
    return reads[rng.permutation(len(reads))]


def write_fastq(reads: np.ndarray, paths: list[str]) -> None:
    """The reads split evenly over ``paths``, gzip level 1, one thread a
    file (zlib releases the interpreter lock)."""
    parts = np.array_split(np.arange(len(reads)), len(paths))

    def one(j):
        idx = parts[j]
        with gzip.open(paths[j], "wb", compresslevel=1) as fh:
            for c0 in range(0, len(idx), 1 << 17):
                sl = idx[c0 : c0 + (1 << 17)]
                fh.write(_fastq_records(reads[sl], int(sl[0]) if len(sl) else 0))

    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        list(pool.map(one, range(len(paths))))
