"""The graph's k-mer table, worked out from the FASTA and the VCF alone.

Upstream varigraph (``src/construct_index.cpp``) indexes every variant site
by the k-mers of each haplotype's context there: the haplotype's own
sequence from k - 1 bases before the site, through its allele, to k - 1
bases after it.  Here a haplotype's sequence is the reference with its
alleles spliced in, so a context is a slice of it; the graph walk is not
needed for sites that do not overlap (the benchmark's panels have none, and
the parser refuses any).  The rules that follow are upstream's:

  * a site keeps the k-mers whose genome count (the counting Bloom filter of
    the reference genome, p = 0.01, seed 0) is at most the site's least
    genome count (taken as 1 when it is 0);
  * a table k-mer's frequency is min(255, max(c, 1) + sites - 1), c its
    genome count when that is at least 2; its haplotype bits are the OR of
    the haplotypes whose context at a keeping site holds it; its ref flag is
    set when a non-REF allele's context holds it, haplotype 0's (the
    reference's) does not, and the genome holds it;
  * a site's k-mer list is its kept k-mers in unsigned order, with the
    haplotypes whose context there holds each; the genotyper reads at most
    128 of them, the lowest frequencies first (stable), in list order when
    there are no more than 128.

Haplotype 0 is the reference; panel haplotype h (1-based) is allele h - 1
of the VCF's samples in column order.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np
import torch

from .kmers import BloomCounts, encode, segment_kmers

MAX_NODE_KMERS = 128
GENOME_COLS = 160   # the genome is counted in rows of 160 bases, overlap k - 1


@dataclass
class Panel:
    chrom: str
    genome: np.ndarray        # uint8 ASCII
    pos: np.ndarray           # int64 [n], 1-based
    ref_len: np.ndarray       # int64 [n]
    alt: list[bytes]
    gt: np.ndarray            # uint8 [n, H + 1], column 0 the reference
    vcf_ploidy: int
    # the VCF's first nine columns of each site, as written
    info: list[list[str]]

    @property
    def nhap(self) -> int:
        return self.gt.shape[1]


def read_panel(fasta: str, vcf: str, vcf_ploidy: int) -> Panel:
    """One chromosome, biallelic sites, phased or unphased GTs without
    missing alleles, sites sorted and not overlapping."""
    name, parts = None, []
    with open(fasta, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    raise ValueError("the reference reads one chromosome")
                name = line[1:].split()[0].decode()
            else:
                parts.append(line.strip())
    genome = np.frombuffer(b"".join(parts), np.uint8).copy()
    pos, rlen, alt, gts, info = [], [], [], [], []
    with gzip.open(vcf, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[0] != name or "," in f[4]:
                raise ValueError("the reference reads biallelic sites of one chromosome")
            p = int(f[1])
            if genome[p - 1 : p - 1 + len(f[3])].tobytes() != f[3].encode():
                raise ValueError(f"REF differs from the FASTA at {p}")
            pos.append(p)
            rlen.append(len(f[3]))
            alt.append(f[4].encode())
            g = "\t".join(f[9:]).replace("|", "\t").replace("/", "\t").split("\t")
            if len(g) != (len(f) - 9) * vcf_ploidy:
                raise ValueError(f"GTs of another ploidy at {p}")
            gts.append(g)
            info.append(f[:9])
    pos = np.asarray(pos, np.int64)
    rlen = np.asarray(rlen, np.int64)
    if len(pos) > 1 and not np.all(pos[1:] > pos[:-1] + rlen[:-1] - 1):
        raise ValueError("the reference reads sites that do not overlap")
    gt = np.zeros((len(pos), 1 + len(gts[0]) if gts else 1), np.uint8)
    if gts:
        gt[:, 1:] = np.asarray(gts, dtype=np.uint8)
    return Panel(name, genome, pos, rlen, alt, gt, vcf_ploidy, info)


@dataclass
class RefTable:
    k: int
    nhap: int
    keys: np.ndarray          # uint64 [M], sorted
    freq: np.ndarray          # uint8 [M]
    bits: np.ndarray          # uint8 [M, nbytes], hap i -> byte i>>3 bit i&7
    flag: np.ndarray          # bool [M]
    # every node of the graph (fillers too), in order
    node_start: np.ndarray    # int64 [N]
    node_end: np.ndarray      # int64 [N]
    node_site: np.ndarray     # int64 [N], the site index, -1 for a filler
    # the genotyper's view of each node's k-mers (<= 128): CSR over nodes
    tbl_off: np.ndarray       # int64 [N + 1]
    tbl_idx: np.ndarray       # int64, table rows
    tbl_lp: np.ndarray        # uint8 [., nbytes] the node's local hap bits
    # every kept k-mer of each node, in unsigned order: CSR over nodes
    kmer_off: np.ndarray
    kmer_val: np.ndarray      # uint64
    kmer_lb: np.ndarray       # uint8 [., nbytes]


def graph_nodes(panel: Panel):
    """(start, end, site) of every node: a filler before each site that
    leaves a gap, the sites, and the tail filler."""
    starts, ends, site = [], [], []
    prev_end = 0
    for i, (p, L) in enumerate(zip(panel.pos, panel.ref_len)):
        if p > prev_end + 1:
            starts.append(prev_end + 1)
            ends.append(p - 1)
            site.append(-1)
        starts.append(int(p))
        ends.append(int(p + L - 1))
        site.append(i)
        prev_end = int(p + L - 1)
    if prev_end < len(panel.genome):
        starts.append(prev_end + 1)
        ends.append(len(panel.genome))
        site.append(-1)
    return (np.asarray(starts, np.int64), np.asarray(ends, np.int64),
            np.asarray(site, np.int64))


def _contexts(panel: Panel, k: int):
    """Distinct (site, context) groups: for each site, the haplotypes that
    agree on every allele a walk of k - 1 bases could reach share one
    context.  Returns (codes, offsets, g_site, g_gt, g_bits [G, nbytes],
    g_h0)."""
    n, H = panel.gt.shape
    alen = np.array([len(a) for a in panel.alt], np.int64)
    # the fewest bases a haplotype can hold between site j's end and site
    # j+1's start is the reference gap; a site holds at least one base
    gap = np.empty(n, np.int64)
    gap[:-1] = panel.pos[1:] - (panel.pos[:-1] + panel.ref_len[:-1])
    gap[-1] = 1 << 40
    # haplotype sequences and each site's start in them
    delta = np.where(panel.gt == 1, (alen - panel.ref_len)[:, None], 0)
    hstart = (panel.pos - 1)[:, None] + np.cumsum(delta, axis=0) - delta
    seqs = {}

    def hapseq(h):
        if h not in seqs:
            parts, cur = [], 0
            for i in np.flatnonzero(panel.gt[:, h]):
                p = int(panel.pos[i]) - 1
                parts.append(panel.genome[cur:p])
                parts.append(np.frombuffer(panel.alt[i], np.uint8))
                cur = p + int(panel.ref_len[i])
            parts.append(panel.genome[cur:])
            seqs[h] = np.concatenate(parts)
        return seqs[h]

    nbytes = (H + 7) // 8
    pieces, g_site, g_gt, g_bits, g_h0 = [], [], [], [], []
    for i in range(n):
        # sites a walk from site i can reach: upstream while the bases
        # certainly collected stay below k - 1, likewise downstream
        lo, got = i, 0
        while lo > 0 and got < k - 1:
            got += gap[lo - 1] + 1
            lo -= 1
        hi, got = i, 0
        while hi < n - 1 and got < k - 1:
            got += gap[hi] + 1
            hi += 1
        sig = panel.gt[lo : hi + 1].T                      # [H, w]
        _, first, inv = np.unique(sig, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
        for g, h in enumerate(first):
            haps = np.flatnonzero(inv == g)
            a = int(panel.gt[i, h])
            s = hapseq(int(h))
            st = int(hstart[i, h])
            L = int(alen[i]) if a else int(panel.ref_len[i])
            pieces.append(s[max(0, st - (k - 1)) : st + L + k - 1])
            row = np.zeros(nbytes, np.uint8)
            np.bitwise_or.at(row, haps >> 3, (1 << (haps & 7)).astype(np.uint8))
            g_site.append(i)
            g_gt.append(a)
            g_bits.append(row)
            g_h0.append(bool(haps[0] == 0))
    lens = np.array([len(p) for p in pieces], np.int64)
    codes = encode(np.concatenate(pieces)) if pieces else np.zeros(0, np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return (codes, offsets, np.asarray(g_site, np.int64),
            np.asarray(g_gt, np.int64),
            np.stack(g_bits) if g_bits else np.zeros((0, nbytes), np.uint8),
            np.asarray(g_h0, bool))


def genome_counts(genome: np.ndarray, k: int, keys: np.ndarray, device,
                  seed: int = 0) -> np.ndarray:
    """The Bloom filter's count of each key: every window of the genome
    added, cut into rows of 160 bases that overlap by k - 1."""
    codes = encode(genome)
    n = len(codes)
    bf = BloomCounts(n - k + 1, seed, device)
    step = GENOME_COLS - (k - 1)
    rows = 1 if n <= GENOME_COLS else -(-(n - GENOME_COLS) // step) + 1
    starts = np.arange(rows, dtype=np.int64) * step
    ends = np.minimum(starts + GENOME_COLS, n)
    idx = np.concatenate([np.arange(a, b) for a, b in zip(starts, ends)])
    offs = np.concatenate([[0], np.cumsum(ends - starts)])
    vals, _ = segment_kmers(torch.from_numpy(codes[idx]).to(device),
                            torch.from_numpy(offs), k)
    bf.add(vals)
    q = torch.from_numpy(keys.view(np.int64)).to(device)
    return bf.count(q).cpu().numpy().astype(np.int64)


def build_table(panel: Panel, k: int, device="cpu") -> RefTable:
    """The table and the nodes' k-mer lists of ``panel`` at k."""
    if k % 2 == 0 or k > 27:
        raise ValueError("the reference counts the genome at odd k <= 27")
    codes, offsets, g_site, g_gt, g_bits, g_h0 = _contexts(panel, k)
    vals, gid = segment_kmers(torch.from_numpy(codes).to(device),
                              torch.from_numpy(offsets), k)
    vals = vals.cpu().numpy().view(np.uint64)
    gid = gid.cpu().numpy()
    # entries (site, group, k-mer), unique per (group, k-mer)
    e = np.unique(np.stack([gid.astype(np.uint64), vals]), axis=1)
    e_gid, e_kh = e[0].astype(np.int64), e[1]
    e_site = g_site[e_gid]
    uniq, inv = np.unique(e_kh, return_inverse=True)
    cnt = genome_counts(panel.genome, k, uniq, device)
    e_fre = cnt[inv]
    # pairs (k-mer, site)
    order = np.lexsort((e_site, e_kh))
    e_site, e_kh, e_gid, e_fre = e_site[order], e_kh[order], e_gid[order], e_fre[order]
    new = np.ones(len(e_kh), bool)
    new[1:] = (e_kh[1:] != e_kh[:-1]) | (e_site[1:] != e_site[:-1])
    st = np.flatnonzero(new)
    p_bits = np.bitwise_or.reduceat(g_bits[e_gid], st, axis=0)
    p_site, p_kh, p_fre = e_site[st], e_kh[st], e_fre[st]
    p_alt = np.logical_or.reduceat(g_gt[e_gid] != 0, st)
    p_h0 = np.logical_or.reduceat(g_h0[e_gid], st)
    p_flag = p_alt & (p_fre >= 1) & ~p_h0
    # keep rule
    n = len(panel.pos)
    minfre = np.full(n, 255, np.int64)
    np.minimum.at(minfre, p_site, p_fre)
    minfre[minfre == 0] = 1
    keep = p_fre <= minfre[p_site]
    p_site, p_kh, p_fre, p_bits, p_flag = (a[keep] for a in (
        p_site, p_kh, p_fre, p_bits, p_flag))
    # the table
    first = np.ones(len(p_kh), bool)
    first[1:] = p_kh[1:] != p_kh[:-1]
    ks = np.flatnonzero(first)
    keys = p_kh[ks]
    nsites = np.diff(np.append(ks, len(p_kh)))
    c = p_fre[ks]
    freq = np.minimum(np.where(c >= 2, c, 1) + nsites - 1, 255).astype(np.uint8)
    bits = np.bitwise_or.reduceat(p_bits, ks, axis=0)
    flag = np.logical_or.reduceat(p_flag, ks)
    # each site's kept k-mers in unsigned order (stable on the k-mer sort)
    so = np.argsort(p_site, kind="stable")
    s_site, s_kh, s_bits = p_site[so], p_kh[so], p_bits[so]
    row = np.searchsorted(keys, s_kh)
    node_start, node_end, node_site = graph_nodes(panel)
    N = len(node_start)
    node_of_site = np.flatnonzero(node_site >= 0)
    site_cnt = np.bincount(s_site, minlength=n)
    kmer_off = np.zeros(N + 1, np.int64)
    per_node = np.zeros(N, np.int64)
    per_node[node_of_site] = site_cnt
    np.cumsum(per_node, out=kmer_off[1:])
    # the genotyper's view: at most 128 a site, lowest frequency first
    f_row = freq[row].astype(np.int64)
    pos_in = np.arange(len(s_site), dtype=np.int64)
    o1 = np.lexsort((pos_in, f_row, s_site))
    seg_start = np.searchsorted(s_site[o1], np.arange(n))
    rank = np.empty(len(o1), np.int64)
    rank[o1] = pos_in - seg_start[s_site[o1]]
    big = site_cnt[s_site] > MAX_NODE_KMERS
    kept = rank < MAX_NODE_KMERS
    sortkey = np.where(big, rank, pos_in)
    o2 = np.lexsort((sortkey[kept], s_site[kept]))
    t_site = s_site[kept][o2]
    tbl_idx = row[kept][o2].astype(np.int64)
    tbl_lp = s_bits[kept][o2]
    per_node[:] = 0
    per_node[node_of_site] = np.bincount(t_site, minlength=n)
    tbl_off = np.zeros(N + 1, np.int64)
    np.cumsum(per_node, out=tbl_off[1:])
    return RefTable(k=k, nhap=panel.nhap, keys=keys, freq=freq, bits=bits,
                    flag=flag, node_start=node_start, node_end=node_end,
                    node_site=node_site, tbl_off=tbl_off, tbl_idx=tbl_idx,
                    tbl_lp=tbl_lp, kmer_off=kmer_off, kmer_val=s_kh,
                    kmer_lb=s_bits)


def save_table(t: RefTable, path: str) -> None:
    np.savez(path, **{f: getattr(t, f) for f in RefTable.__dataclass_fields__})


def load_table(path: str) -> RefTable:
    with np.load(path) as z:
        d = {f: z[f] for f in z.files}
    d["k"], d["nhap"] = int(d["k"]), int(d["nhap"])
    return RefTable(**d)
