"""Counting, the coverage model and the calls, worked out again in plain
torch and numpy from the reads, the table of ``table.py`` and the panel.

The scoring is a frozen copy of the port's plain scoring path (its window
prep, ``_emissions_body``, ``_scan`` and the posterior), which follows
upstream's ``src/genotype.cpp`` (``hidden_states`` :618-821,
``observable_states`` :979-1017, forward/backward :1175-1357, posterior
:1371-1546), with every float computed in ``dtype``: float64 for the
reference, a lower precision for its control.  The counting and the
coverage model are upstream's ``fastq_kmer`` and ``cal_hap_kmer_cov``
(``src/varigraph.cpp:220-401``).
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np
import torch

from .kmers import encode, segment_kmers
from .table import MAX_NODE_KMERS, Panel, RefTable


# ------------------------------------------------------------------ counting

def read_fastq(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint8 [T], offsets int64 [R + 1]) of a FASTQ file's reads."""
    with gzip.open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    seqs = lines[1::4]
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    return encode(np.frombuffer(b"".join(seqs), np.uint8)), np.concatenate(
        [[0], np.cumsum(lens)])


def count_reads(paths: list[str], keys: np.ndarray, k: int, device
                ) -> tuple[np.ndarray, int]:
    """(cov int64 [M], bases read): each emitted k-mer of each read adds one
    to its key."""
    keys_t = torch.from_numpy(keys.view(np.int64)).to(device)
    if keys.size and keys[-1] >= np.uint64(1 << 63):
        raise ValueError("keys past 2^63 need an unsigned search")
    cov = torch.zeros(len(keys), dtype=torch.int64, device=device)
    bases = 0
    for p in paths:
        codes, offs = read_fastq(p)
        bases += int(offs[-1])
        vals, _ = segment_kmers(torch.from_numpy(codes).to(device),
                                torch.from_numpy(offs), k)
        if len(keys) == 0:
            continue
        at = torch.searchsorted(keys_t, vals).clamp_(max=len(keys) - 1)
        hit = keys_t[at] == vals
        cov += torch.bincount(at[hit], minlength=len(keys))
    return cov.cpu().numpy(), bases


# ------------------------------------------------------------ coverage model

def hap_coverage(cov: np.ndarray, t: RefTable, vcf_ploidy: int,
                 sample_ploidy: int, read_depth: float) -> float:
    """Haplotype k-mer coverage: the peak of the coverage histogram of
    k-mers with c > 0 and f == 1 that some fully homozygous panel sample
    carries, over the sample ploidy."""
    c8 = np.minimum(cov, 255)
    cand = np.flatnonzero((c8 > 0) & (t.freq == 1))
    nsample = (t.nhap - 1) // vcf_ploidy
    hist = np.zeros(256, np.int64)
    for lo in range(0, len(cand), 1 << 18):
        idx = cand[lo : lo + (1 << 18)]
        bits = np.unpackbits(t.bits[idx], axis=1, bitorder="little")[:, 1 : 1 + nsample * vcf_ploidy]
        hom = bits.reshape(len(idx), nsample, vcf_ploidy).all(axis=2).any(axis=1)
        hist += np.bincount(c8[idx[hom]], minlength=256)
    cs = [c for c in range(256) if hist[c] > 0]
    fs = [int(hist[c]) for c in cs]
    best, hom_cov, best_f = -1, 0, 0
    for i, (c, f) in enumerate(zip(cs, fs)):
        if c > 1 and f >= best_f and c < 255:
            best, best_f, hom_cov = i, f, c
    if best == -1:
        raise ValueError("no coverage peak")
    for i in range(best + 1, len(fs) - 1):
        if cs[i] > read_depth:
            break
        if fs[i] >= fs[i - 1] and fs[i] >= fs[i + 1]:
            hom_cov = cs[i]
    return hom_cov / sample_ploidy if hom_cov > 0 else read_depth / sample_ploidy


# ----------------------------------------------------------------- haplotype
# selection and states (upstream genotype.cpp:519-594, 835-919)

def window_hap_counts(idx, cov8, freq, bits, nhap):
    counts = np.zeros(nhap, np.uint64)
    if not len(idx):
        return counts
    c = cov8[idx]
    keep = (c > 1) & (freq[idx] == 1)
    if not keep.any():
        return counts
    rows = np.unpackbits(bits[idx[keep]], axis=1, bitorder="little")[:, :nhap]
    return (rows.astype(np.uint64) * c[keep, None].astype(np.uint64)).sum(axis=0)


def dirichlet_top_haps(counts, haploid_num, rng):
    h = len(counts)
    freq = np.zeros(h, np.float64)
    for i in np.nonzero(counts)[0]:
        freq[i] = rng.gamma(shape=float(counts[i]) + 1.0, scale=1.0)
    s = freq.sum()
    if s > 0:
        freq = freq / s
    n = min(haploid_num, h)
    top = np.lexsort((np.arange(h), -freq))[:n]
    total = freq[top].sum()
    score = {int(i): (float(freq[i]) / total if total > 0 else float("nan"))
             for i in top}
    return sorted(int(i) for i in top), score


def states_of(top, sample_type, ploidy, max_hap):
    if ploidy > 2:
        out = []
        for hap in top:
            if hap == 0:
                out.append((0,) * ploidy)
            else:
                first = (math.ceil(hap / float(ploidy)) - 1) * ploidy + 1
                out.append(tuple(0 if v > max_hap else v
                                 for v in range(first, first + ploidy)))
        return [list(v) for v in sorted(set(out))]
    hap_num = len(top) - 1
    idx_vecs = []
    for hi in range(len(top)):
        vec = [hi] * ploidy
        idx_vecs.append(list(vec))
        if sample_type == "hom":
            continue
        m = min(vec[1:])
        while m < hap_num:
            j = len(vec) - 1
            while vec[j] == hap_num:
                vec[j] = m + 1
                j -= 1
            vec[j] += 1
            idx_vecs.append(list(vec))
            m = min(vec[1:])
    return [[top[i] for i in v] for v in idx_vecs]


def make_windows(starts, chrom_len, granularity):
    if not len(starts):
        return []
    step = min(granularity, chrom_len)
    out, end, n = [], 0, len(starts)
    for i in range(math.ceil(chrom_len / step)):
        lo = end
        if lo >= n:
            break
        j = lo
        while j < n and starts[j] <= (i + 1) * step:
            j += 1
        end = j
        out.append((lo, end))
    return out


def _csr_rows(off, nodes):
    lens = off[nodes + 1] - off[nodes]
    if lens.sum() == 0:
        return np.empty(0, np.int64)
    c0 = np.zeros(len(nodes), np.int64)
    np.cumsum(lens[:-1], out=c0[1:])
    return np.repeat(off[nodes] - c0, lens) + np.arange(int(lens.sum()))


class Window:
    """One window's inputs to the HMM (the port's ``_WindowPrep``)."""

    def __init__(self, t: RefTable, gt_nodes, cfg, lo, hi, rng, cov8, hap_cov):
        nhap = t.nhap
        var = np.arange(lo, hi)[t.node_site[lo:hi] >= 0]
        counts = window_hap_counts(t.tbl_idx[_csr_rows(t.tbl_off, var)],
                                   cov8, t.freq, t.bits, nhap)
        self.top, self.score = dirichlet_top_haps(
            counts, min(cfg["haploid_num"], nhap), rng)
        self.states = states_of(self.top, cfg["sample_type"],
                                cfg["sample_ploidy"], nhap - 1)
        self.used = sorted({h for s in self.states for h in s})
        S, U, P = len(self.states), len(self.used), cfg["sample_ploidy"]
        hap2u = {h: i for i, h in enumerate(self.used)}
        cnt = np.zeros((S, U), np.int64)
        for si, s in enumerate(self.states):
            for h in s:
                cnt[si, hap2u[h]] += 1
        self.state_cnt = cnt
        self.overlap = np.minimum(cnt[:, None, :], cnt[None, :, :]).sum(axis=2)
        self.nodes = var
        n, K = len(var), MAX_NODE_KMERS
        lam = float(hap_cov)
        self.lower = lam - 1.96 * math.sqrt(lam)
        self.upper = lam + 1.96 * math.sqrt(lam)
        self.c = np.zeros((n, K), np.int64)
        self.f = np.zeros((n, K), np.int64)
        self.flag = np.zeros((n, K), bool)
        self.kmask = np.zeros((n, K), bool)
        self.bits_u = np.zeros((n, K, U), np.uint8)
        self.local_u = np.zeros((n, K, U), np.uint8)
        self.kind = np.ones(n, np.int64)
        self.G_nu = gt_nodes[var][:, self.used].astype(np.int64)
        lens = t.tbl_off[var + 1] - t.tbl_off[var]
        if lens.sum() > 0:
            rows = _csr_rows(t.tbl_off, var)
            tidx = t.tbl_idx[rows]
            node_of = np.repeat(np.arange(n), lens)
            allb = np.unpackbits(t.bits[tidx], axis=1, bitorder="little")[:, :nhap]
            keep = allb[:, self.top].any(axis=1)
            act, an = tidx[keep], node_of[keep]
            kc = np.bincount(an, minlength=n)
            ko = np.zeros(n + 1, np.int64)
            np.cumsum(kc, out=ko[1:])
            pos = np.arange(len(act)) - ko[an]
            self.kind[kc == 0] = 2
            self.c[an, pos] = cov8[act]
            self.f[an, pos] = t.freq[act]
            self.flag[an, pos] = t.flag[act]
            self.kmask[an, pos] = True
            self.bits_u[an, pos] = allb[keep][:, self.used]
            loc = np.unpackbits(t.tbl_lp[rows][keep], axis=1, bitorder="little")
            self.local_u[an, pos] = loc[:, self.used]
        else:
            self.kind[:] = 2
        st, en = t.node_start[var], t.node_end[var]
        df = np.zeros(n, np.int64)
        db = np.zeros(n, np.int64)
        if n:
            df[0] = st[0] & 0xFFFFFFFF
            df[1:] = (st[1:] - en[:-1]) & 0xFFFFFFFF
            db[n - 1] = (-en[n - 1]) & 0xFFFFFFFF
            db[:-1] = (st[1:] - en[:-1]) & 0xFFFFFFFF
        self.dist_f, self.dist_b = df, db
        self.log_w = np.array([sum(math.log(self.score[h]) if self.score.get(h, 0) > 0
                                   else -math.inf for h in s) for s in self.states])


def _transition_logs(dist, nhap):
    d = dist.astype(np.float64) * 0.000004 * 1.26 * 1e-05
    ex = np.exp(-d / nhap)
    rec = (1.0 - ex) * (1.0 / nhap)
    with np.errstate(divide="ignore"):
        return np.log(rec), np.log(ex + rec)


def _emissions(w: Window, ave, p_err, dtype, device):
    """logE [n, S] of one window (the port's ``_emissions_body``)."""
    T = lambda a, dt=dtype: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    q = 1.0 - p_err
    log_prior = math.log(1.0 / math.sqrt(2 * math.pi * 0.05)) - (p_err - 0.5) ** 2 / (2 * 0.05)
    sc = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    ave_t, lo_t, up_t = sc(ave), sc(w.lower), sc(w.upper)
    lp, lq, lpr = sc(math.log(p_err)), sc(math.log(q)), sc(log_prior)
    cnt = T(w.state_cnt)                                  # [S, U] -> [U, S]
    n = len(w.nodes)
    out = torch.empty((n, len(w.states)), dtype=dtype, device=device)
    step = max(1, (1 << 22) // (MAX_NODE_KMERS * max(len(w.states), len(w.used))))
    for a in range(0, n, step):
        b = min(n, a + step)
        cf = T(w.c[a:b])
        f = torch.as_tensor(w.f[a:b], device=device)
        flag = torch.as_tensor(w.flag[a:b], device=device)
        km = torch.as_tensor(w.kmask[a:b], device=device)
        bits = T(w.bits_u[a:b])
        loc = T(w.local_u[a:b])
        gt0 = torch.as_tensor(w.G_nu[a:b] == 0, device=device)
        ci = flag[..., None] & gt0[:, None, :] & ((cf >= lo_t) & (cf <= up_t))[..., None]
        htmp = torch.where(ci, torch.ones_like(bits), bits)
        h = torch.einsum("bku,su->bks", htmp, cnt)
        trig = ((cf < lo_t) & (f >= 2))[..., None] & (htmp > 0) & km[..., None]
        need = trig.any(dim=1)
        ver = (cf <= lo_t) & (f >= 2)
        dec_u = ver[..., None] & (htmp == 1) & need[:, None, :] & (loc == 0)
        h = torch.clamp(h - torch.einsum("bku,su->bks", dec_u.to(dtype), cnt), min=0)
        fe = torch.where(flag & (f == 1), 2, f)[..., None]
        cB = cf[..., None]
        ff = fe.to(dtype)
        cc = torch.where(
            fe == 1, cB,
            torch.where((h > 0) & (cB > ave_t * h), torch.floor(ave_t * h),
                        torch.where((h == 0) & (cB > ave_t),
                                    torch.where(ff > cB / up_t, torch.zeros_like(cB),
                                                torch.floor(cB / ff)),
                                    torch.where((h == 0) & (cB <= ave_t),
                                                torch.floor(cB / ff), cB))))
        geo = lpr + cc * lq + (1.0 - cc) * lp
        mean = ave_t * h
        poi = -mean + cc * torch.log(torch.clamp(mean, min=1e-30)) - torch.lgamma(cc + 1.0)
        terms = torch.where(h == 0, geo, poi)
        terms = torch.where(km[..., None], terms, torch.zeros_like(terms))
        out[a:b] = terms.sum(dim=1)
    return out


def _scan(logE, kind, lrec, lnorec, overlap, e_lw, smask, fre, P, reverse):
    """One normalized chain a window over the node axis, batched over the
    windows (the port's ``_scan``): logE [W, N, S], kind [W, N] (0 pad,
    1 real, 2 reset), per-node transition logs [W, N], overlap [W, S, S],
    e_lw and smask [W, S].  Returns [W, N, S], zeros where not real."""
    W, N, S = logE.shape
    dt, dev = logE.dtype, logE.device
    cls = torch.arange(P + 1, dtype=dt, device=dev)
    M = (overlap[:, None] == torch.arange(P + 1, device=dev)[None, :, None, None]).to(dt)
    uniform = torch.where(smask, 1.0 / smask.sum(dim=1, keepdim=True).to(dt),
                          torch.zeros((), dtype=dt, device=dev))
    alpha = torch.zeros((W, S), dtype=dt, device=dev)
    fresh = torch.ones(W, dtype=torch.bool, device=dev)
    out = torch.zeros((W, N, S), dtype=dt, device=dev)
    ninf = torch.tensor(-math.inf, dtype=dt, device=dev)
    for i in (range(N - 1, -1, -1) if reverse else range(N)):
        le = logE[:, i]
        mx = torch.where(smask, le, ninf).amax(dim=1, keepdim=True)
        e = torch.where(smask, torch.exp(le - mx), torch.zeros((), dtype=dt, device=dev))
        if fre:
            flow = alpha.sum(dim=1, keepdim=True) * e_lw
        else:
            a = torch.where(cls == 0, 0.0, cls * lnorec[:, i, None])
            b = torch.where(P - cls == 0, 0.0, (P - cls) * lrec[:, i, None])
            t = torch.exp(a + b)                                   # [W, P+1]
            flow = ((M @ alpha[:, None, :, None])[..., 0] * t[:, :, None]).sum(dim=1)
        raw = torch.where(fresh[:, None], e, flow * e)
        tot = raw.sum(dim=1, keepdim=True)
        stepped = torch.where(tot > 0, raw / torch.where(tot > 0, tot, 1.0), uniform)
        real = kind[:, i] == 1
        alpha = torch.where(real[:, None], stepped, alpha)
        fresh = torch.where(real, False, (kind[:, i] == 2) | fresh)
        out[:, i] = torch.where(real[:, None], alpha, torch.zeros((), dtype=dt, device=dev))
    return out


def _posterior(w: Window, alpha: np.ndarray, beta: np.ndarray, gt_nodes, t, out):
    ab = alpha * beta
    den = ab.sum(axis=1)
    post = np.where((den != 0)[:, None], ab / np.where(den != 0, den, 1.0)[:, None], 0.0)
    nak = (w.bits_u * w.kmask[:, :, None]).sum(axis=1)
    cak = (w.c[:, :, None] * w.bits_u * w.kmask[:, :, None]).sum(axis=1)
    uk = np.minimum(((w.f <= 1) & w.kmask).sum(axis=1), 255)
    hap2u = {h: i for i, h in enumerate(w.used)}
    for ni, node in enumerate(w.nodes):
        if w.kind[ni] != 1:
            continue
        hg = gt_nodes[node]
        geno = ["/".join(sorted(str(int(hg[h])) for h in s)) for s in w.states]
        tot: dict[str, float] = {}
        for si, g in enumerate(geno):
            tot[g] = tot.get(g, 0.0) + post[ni, si]
        best, score = None, -1.0
        for g in sorted(tot):
            if tot[g] > score:
                best, score = g, tot[g]
        maxp, win = 0.0, None
        for si, g in enumerate(geno):
            if g == best and maxp < post[ni, si]:
                maxp, win = post[ni, si], si
        if win is None:
            continue
        haps = w.states[win]
        nums = [int(nak[ni, hap2u[h]]) for h in haps]
        covs = [float(cak[ni, hap2u[h]]) / m if m else 0.0
                for h, m in zip(haps, nums)]
        out[int(t.node_start[node])] = ("/".join(str(int(hg[h])) for h in haps),
                                        float(score), nums, covs, int(uk[ni]))


def call_sites(t: RefTable, panel: Panel, cov: np.ndarray, hap_cov: float,
               cfg: dict, seed: int, dtype=torch.float64, device="cpu",
               chains: list | None = None):
    """{site start: (GT, GPP, NAK, CAK, UK)} of every scored site, as the
    genotyper's posterior leaves them (before the VCF drops all-REF calls).
    chains: if given, gets (logE, alpha, beta) of each window that has
    nodes, float64 numpy [nodes, states], in window order."""
    cov8 = np.minimum(cov, 255).astype(np.uint8)
    gt_nodes = np.zeros((len(t.node_start), t.nhap), np.uint8)
    gt_nodes[t.node_site >= 0] = panel.gt
    ave = float(np.float32(hap_cov))
    p_err = 0.99 if ave < 10 else 0.95 if ave < 20 else 0.9 if ave < 40 else 0.8
    crc = zlib.crc32(panel.chrom.encode()) & 0x7FFFFFFF
    out: dict = {}
    P = cfg["sample_ploidy"]
    fre = cfg["mode"] != "rec"
    wins, logEs = [], []
    for w_id, (lo, hi) in enumerate(make_windows(
            t.node_start, len(panel.genome), int(cfg["granularity_bp"]))):
        rng = np.random.Generator(np.random.PCG64([seed, crc, w_id]))
        w = Window(t, gt_nodes, cfg, lo, hi, rng, cov8, hap_cov)
        if len(w.nodes):
            wins.append(w)
            logEs.append(_emissions(w, ave, p_err, dtype, device).cpu())
    if not wins:
        return out
    # the chains run on the host, every window at once: a step is too
    # small for a device
    W = len(wins)
    N = max(len(w.nodes) for w in wins)
    S = max(len(w.states) for w in wins)
    logE = torch.full((W, N, S), -math.inf, dtype=dtype)
    kind = torch.zeros((W, N), dtype=torch.int64)
    ov = torch.zeros((W, S, S), dtype=torch.int64)
    smask = torch.zeros((W, S), dtype=torch.bool)
    e_lw = torch.zeros((W, S), dtype=dtype)
    logs = [torch.zeros((W, N), dtype=dtype) for _ in range(4)]
    for j, (w, le) in enumerate(zip(wins, logEs)):
        n, s = le.shape
        logE[j, :n, :s] = le
        kind[j, :n] = torch.as_tensor(w.kind)
        ov[j, :s, :s] = torch.as_tensor(w.overlap)
        smask[j, :s] = True
        e_lw[j, :s] = torch.exp(torch.as_tensor(w.log_w).to(dtype))
        for x, v in zip(logs, (*_transition_logs(w.dist_f, t.nhap),
                               *_transition_logs(w.dist_b, t.nhap))):
            x[j, :n] = torch.as_tensor(v).to(dtype)
    alpha = _scan(logE, kind, logs[0], logs[1], ov, e_lw, smask, fre, P, False)
    beta = _scan(logE, kind, logs[2], logs[3], ov, e_lw, smask, fre, P, True)
    for j, w in enumerate(wins):
        n, s = len(w.nodes), len(w.states)
        a = alpha[j, :n, :s].double().numpy()
        b = beta[j, :n, :s].double().numpy()
        if chains is not None:
            chains.append((logE[j, :n, :s].double().numpy(), a, b))
        _posterior(w, a, b, gt_nodes, t, out)
    return out


def vcf_records(calls: dict) -> dict:
    """The calls a VCF keeps: {start: (GT, GPP, NAK, CAK, UK)} without the
    all-REF ones."""
    return {s: c for s, c in calls.items()
            if not all(g in ("0", ".") for g in c[0].split("/"))}


def read_vcf_calls(path: str) -> dict:
    """{start: (GT, GPP, NAK, CAK, UK, GQ)} of a genotyped VCF, as written."""
    out = {}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gt, gq, gpp, nak, cak, uk = f[9].split(":")
            out[int(f[1])] = (gt, float(gpp), [int(x) for x in nak.split(",")],
                              [float(x) for x in cak.split(",")], int(uk),
                              float(gq))
    return out

