"""Device (torch) genotyping engine.

Port of ``varigraph_tpu/genotype/engine_jax.py``, validated against the
extended-precision oracle in engine_np.py (which ports reference
src/genotype.cpp -- see its docstring for the file:line map):

  * hidden states + emissions: log-emission matrices [windows, nodes,
    states].  On the card the hand kernel ``csrc/emit.cu``
    (``ops/emit_cuda.py``) scores each (node, state) from the hap words and
    a per-k-mer term table.  Its plain version, ``_emissions_body``, takes
    the reference's per-k-mer scalar branches (ref-flag CI rule,
    local-bitmask verification, coverage rescaling, Poisson/geometric
    scoring) as selects over [windows, nodes, kmers, haps/states] tensors,
    and the per-state copy-count sums as two contractions against the
    state-count matrix.
  * forward/backward: ``_forward_backward`` runs the hand kernel
    ``csrc/fb.cu`` on the card (``ops/fb_cuda.py``): one CTA a window and
    direction walks the nodes.  Its plain version, ``_scan``, loops over
    nodes batched over windows; the transition is P+1 class masks times
    per-step scalar weights.  ``kind`` resets the chain or skips pad nodes.
  * window prep and posterior aggregation (string-keyed genotype grouping,
    NAK/CAK/UK) stay on the host, copied from the JAX engine.
  * several devices and processes (engine_jax.py:537-551,604-625,781-784):
    each process scores its round-robin share of the windows and the
    results merge at the end (parallel/dist.py); within a process, a mesh
    of several devices splits each group's window axis for the
    forward/backward.  Windows are independent chains, so both give the
    one-device results.

Float32 on the device; the oracle engine is the precision reference.
"""

from __future__ import annotations

import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..index.structs import GraphIndex
from ..ops.emit_cuda import emissions_
from ..ops.fb_cuda import forward_backward
from ..ops.table import pack_hapbits
from ..parallel import dist
from ..parallel.mesh import Mesh
from ..utils.log import log
from .combos import increment_vector
from .engine_np import (
    PosteriorRecord,
    get_error_param,
    make_windows,
    poisson_interval,
    window_rng_seed,
)
from .hapselect import dirichlet_top_haps, window_hap_counts

MAX_NODE_KMERS = 128

# windows scored per round; bounds the [W, N, S] alpha/beta memory at genome
# scale
_WINDOW_GROUP = 256
# the plain emissions on the CPU: padded node rows per call, bounding the
# [rows, K, S] intermediates (rows*K*S*4 B per live tensor; 4096 rows at
# K=S=128 is ~0.27 GB)
_EMIT_ROWS = 4096
# nodes per plain emission call inside one window that alone exceeds
# _EMIT_ROWS
_NODE_CHUNK = 1024
# the emissions kernel on the card: input bytes uploaded per launch (the
# kernel holds no intermediate, so a group is one launch up to this)
_EMIT_UPLOAD_BYTES = 1 << 30


# ======================================================================
# emissions
# ======================================================================

def _unpack_bits32(pk: torch.Tensor) -> torch.Tensor:
    """[..., W] uint32 words held in int64 -> [..., W*32] f32 0/1 (bit i of
    word w is used-hap index w*32+i).  int64, because torch has few uint32
    operations."""
    shifts = torch.arange(32, dtype=torch.int64, device=pk.device)
    b = (pk[..., None] >> shifts) & 1
    return b.to(torch.float32).flatten(-2)


def _emissions_body(
    c,          # [G, B, K] int32   raw coverage (saturated u8)
    f,          # [G, B, K] int32   graph frequency
    flag,       # [G, B, K] bool    ref flag
    kmask,      # [G, B, K] bool    valid k-mer
    bits_pk,    # [G, B, K, W] int64  packed global hap bits (u32 words)
    local_pk,   # [G, B, K, W] int64  packed node-local hap bits (u32 words)
    gt0_u,      # [G, B, U] bool    hap's GT at this node == 0 (U = W*32)
    state_cnt,  # [G, U, S] f32     count of used-hap u in state s's combo
    smask,      # [G, S] bool       valid state
    ave,        # float             hap k-mer coverage
    lower, upper,  # floats         95% CI
    log_p, log_q, log_prior,  # floats of the geometric model
):
    """Returns logE [G, B, S] (f32): per-state log emission scores for G
    windows of B nodes each.  The JAX body scores one window; here windows
    are a leading batch dimension, each with its own state-count matrix and
    state mask.  Scalars should be float32-representable (the JAX engine
    computes in float32).  Padding u-columns are inert: their bits are 0,
    gt0_u is False, and state_cnt rows are 0."""
    bits_u = _unpack_bits32(bits_pk)         # [G, B, K, U] f32 0/1
    local_u = _unpack_bits32(local_pk)
    # hTmp per (k, u): ref-flag CI inclusion (genotype.cpp:702)
    cf = c.to(torch.float32)
    ci = flag[..., None] & gt0_u[:, :, None, :] & (
        (cf >= lower) & (cf <= upper)
    )[..., None]
    htmp = torch.where(ci, 1.0, bits_u)      # [G, B, K, U]

    # h per (k, s): sum of copy counts over the state's haplotypes
    h = torch.einsum("gbku,gus->gbks", htmp, state_cnt)

    # verification (genotype.cpp:706-812) via local bitmasks
    trigger = ((cf < lower) & (f >= 2))[..., None] & (htmp > 0) & kmask[..., None]
    need_u = trigger.any(dim=2)              # [G, B, U]
    verify_k = (cf <= lower) & (f >= 2)      # [G, B, K]
    dec_u = (
        verify_k[..., None]
        & (htmp == 1.0)
        & need_u[:, :, None, :]
        & (local_u == 0.0)
    )                                        # [G, B, K, U]
    dec = torch.einsum("gbku,gus->gbks", dec_u.to(torch.float32), state_cnt)
    h = torch.clamp(h - dec, min=0.0)

    # effective frequency (genotype.cpp:713-718)
    f_eff = torch.where(flag & (f == 1), 2, f)[..., None]   # [G, B, K, 1]

    # coverage rescaling (find_most_likely_depth, genotype.cpp:1136-1158)
    cB = cf[..., None]                       # [G, B, K, 1]
    ff = f_eff.to(torch.float32)
    cap = torch.floor(ave * h)               # uint8 truncation
    c_div_f = torch.floor(cB / ff)
    cond_h_hi = (h > 0) & (cB > ave * h)
    cond_0_hi = (h == 0) & (cB > ave)
    cond_0_lo = (h == 0) & (cB <= ave)
    zero_out = ff > (cB / upper)
    cc = torch.where(
        f_eff == 1,
        cB,
        torch.where(
            cond_h_hi, cap,
            torch.where(
                cond_0_hi, torch.where(zero_out, 0.0, c_div_f),
                torch.where(cond_0_lo, c_div_f, cB),
            ),
        ),
    )  # [G, B, K, S]

    # log emissions
    # h == 0: geometric = prior(p) * q^c * p^(1-c)  (genotype.cpp:1095-1120)
    log_geo = log_prior + cc * log_q + (1.0 - cc) * log_p
    # h > 0: Poisson(mean = ave*h) at cc  (genotype.cpp:1030-1039)
    mean = ave * h
    log_poi = (-mean + cc * torch.log(torch.clamp(mean, min=1e-30))
               - torch.lgamma(cc + 1.0))
    terms = torch.where(h == 0, log_geo, log_poi)         # [G, B, K, S]
    terms = torch.where(kmask[..., None], terms, 0.0)
    logE = terms.sum(dim=2)                               # [G, B, S]
    return torch.where(smask[:, None, :], logE, -math.inf)


# ======================================================================
# forward/backward
# ======================================================================

def _scan(logE, kind, log_rec, log_norec, M, e_lw, smask, uniform,
          fre_mode: bool, P: int, reverse: bool):
    """One normalized scan over the node axis, batched over windows.
    Returns [W, N, S] with zeros at nodes that are not real (kind != 1)."""
    W, N, S = logE.shape
    dev = logE.device
    cls = torch.arange(P + 1, dtype=torch.float32, device=dev)   # [P+1]
    mcls = P - cls
    Mr = M.permute(0, 2, 1, 3).reshape(W, S, (P + 1) * S)       # [W, S, C*S]
    alpha = torch.zeros((W, S), dtype=torch.float32, device=dev)
    fresh = torch.ones(W, dtype=torch.bool, device=dev)
    out = torch.zeros((W, N, S), dtype=torch.float32, device=dev)
    for i in (range(N - 1, -1, -1) if reverse else range(N)):
        le = logE[:, i]
        knd = kind[:, i]
        mx = torch.where(smask, le, -math.inf).amax(dim=1, keepdim=True)
        e = torch.where(smask, torch.exp(le - mx), 0.0)
        if fre_mode:
            # rank-1 flow: every state receives the total mass times its
            # haplotype-frequency factor
            flow = alpha.sum(dim=1, keepdim=True) * e_lw
        else:
            # T[s, j] = norec^ov * rec^(P-ov): P+1 class masks, each weighted
            # by t_c = exp(c*lnr + (P-c)*lr); safe at rec == 0 (exponent 0
            # -> factor 1)
            a = torch.where(cls == 0, 0.0, cls * log_norec[:, i, None])
            b = torch.where(mcls == 0, 0.0, mcls * log_rec[:, i, None])
            t = torch.exp(a + b)                                 # [W, P+1]
            am = torch.bmm(alpha[:, None, :], Mr).view(W, P + 1, S)
            flow = (am * t[:, :, None]).sum(dim=1)
        raw = torch.where(fresh[:, None], e, flow * e)
        tot = raw.sum(dim=1, keepdim=True)
        stepped = torch.where(tot > 0, raw / tot, uniform)
        real = knd == 1
        alpha = torch.where(real[:, None], stepped, alpha)
        fresh = torch.where(real, False, (knd == 2) | fresh)
        out[:, i] = torch.where(real[:, None], alpha, 0.0)
    return out


def _forward_backward_plain(
    logE,        # [W, N, S] f32
    kind,        # [W, N] int32  0=pad 1=real 2=reset
    log_rec_f, log_norec_f,  # [W, N] f32 (forward distances)
    log_rec_b, log_norec_b,  # [W, N] f32 (backward distances)
    overlap,     # [W, S, S] int32
    log_w,       # [W, S] f32  per-state hap-frequency factor ('fre' mode)
    smask,       # [W, S] bool
    fre_mode: bool,
    P: int,
):
    """Returns (alpha, beta) [W, N, S] in plain torch: P+1 overlap-class
    masks and a ``_scan`` a direction.  Windows are independent chains."""
    classes = torch.arange(P + 1, dtype=overlap.dtype, device=overlap.device)
    M = (overlap[:, None, :, :] == classes[None, :, None, None]).to(
        torch.float32)                                        # [W, P+1, S, S]
    nvalid = smask.sum(dim=1, keepdim=True).to(torch.float32)
    uniform = torch.where(smask, 1.0 / nvalid, 0.0)
    e_lw = torch.exp(torch.where(smask, log_w, 0.0))
    alpha = _scan(logE, kind, log_rec_f, log_norec_f, M, e_lw, smask, uniform,
                  fre_mode, P, reverse=False)
    beta = _scan(logE, kind, log_rec_b, log_norec_b, M, e_lw, smask, uniform,
                 fre_mode, P, reverse=True)
    return alpha, beta


# the scoring's forward/backward: the hand kernel csrc/fb.cu on CUDA tensors,
# _forward_backward_plain on CPU tensors
_forward_backward = forward_backward


# ======================================================================
# host orchestration (copied from engine_jax)
# ======================================================================

def _transition_logs(dist: np.ndarray, nhap: int):
    """log(recomb), log(norecomb) per distance (genotype.cpp:954-964)."""
    d = dist.astype(np.float64) * 0.000004 * 1.26 * 1e-05
    n = float(nhap)
    ex = np.exp(-d / n)
    rec = (1.0 - ex) * (1.0 / n)
    norec = ex + rec
    with np.errstate(divide="ignore"):
        return (
            np.log(rec).astype(np.float32),
            np.log(norec).astype(np.float32),
        )


def _csr_flat(off: np.ndarray, node_idx: np.ndarray) -> np.ndarray:
    """Flat row indices of the CSR segments for the given nodes, in node
    order: concat(arange(off[i], off[i+1]) for i in node_idx), vectorized."""
    lens = off[node_idx + 1] - off[node_idx]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum0 = np.zeros(len(node_idx), np.int64)
    np.cumsum(lens[:-1], out=cum0[1:])
    return np.repeat(off[node_idx] - cum0, lens) + np.arange(total, dtype=np.int64)


class _WindowPrep:
    """Host-side gather of one window's tensors.

    Haplotype bits arrive packed ([M, W] uint32); only this window's gathered
    rows are unpacked, so host memory stays bounded at genome scale."""

    def __init__(self, gi, cfg, chrom, lo, hi, rng, cov_u8, freq_np, hap_words,
                 refflag, hap_cov):
        self.chrom = chrom
        nodes = gi.graph.nodes[chrom]
        self.cfg = cfg
        nhap = gi.nhap

        gt_len = gi.graph.gt_len[chrom]
        variant_idx = np.arange(lo, hi, dtype=np.int64)[gt_len[lo:hi] > 1]
        tbl_off, tbl_idx, tbl_lp = gi.graph.tbl_csr[chrom]
        counts = window_hap_counts(
            [tbl_idx[_csr_flat(tbl_off, variant_idx)]],
            cov_u8, freq_np, hap_words, nhap,
        )
        haploid_num = min(cfg.haploid_num, nhap)
        self.top_hap, self.score_map = dirichlet_top_haps(counts, haploid_num, rng)
        self.states = increment_vector(
            self.top_hap, cfg.sample_type, cfg.sample_ploidy, nhap - 1
        )
        self.used_haps = sorted({h for s in self.states for h in s})

        self.overlap = state_overlap(self.states)

        # scorable nodes (genotype.cpp:257-277), via the dense per-chrom
        # metadata (gt_len) instead of per-node Python attribute walks
        cand = variant_idx
        if cfg.sv_genotype_only:
            vcf_info_chrom = gi.vcf_info.get(chrom, {})
            keep = []
            for i in cand:
                info = vcf_info_chrom.get(int(nodes[i].start))
                if info is None:
                    raise ValueError(
                        f"'{chrom}:{nodes[i].start}' does not exist in the VCF file."
                    )
                if len(info[3]) >= 50 or len(info[4]) >= 50:
                    keep.append(i)
            cand = np.asarray(keep, np.int64)
        self.node_idx = cand
        self.node_refs = [nodes[i] for i in cand]

        lower, upper = poisson_interval(float(hap_cov))
        self.lower, self.upper = lower, upper

        n = len(self.node_refs)
        U = len(self.used_haps)
        K = MAX_NODE_KMERS
        self.c = np.zeros((n, K), np.int32)
        self.f = np.zeros((n, K), np.int32)
        self.flag = np.zeros((n, K), bool)
        self.kmask = np.zeros((n, K), bool)
        self.bits_u = np.zeros((n, K, U), np.uint8)
        self.local_u = np.zeros((n, K, U), np.uint8)
        self.kind = np.ones(n, np.int32)

        starts = gi.graph.starts_np[chrom][cand]
        ends = gi.graph.ends_np[chrom][cand]

        # per-node GT values of the used haplotypes [n, U] (one dense gather
        # instead of an O(n*U) Python loop); gt0_u feeds the emission
        # kernel's ref-flag CI rule, G_nu feeds posterior grouping
        self.G_nu = gi.graph.gt_submatrix(chrom, cand, self.used_haps)
        self.gt0_u = self.G_nu == 0

        # flat gather across all nodes of the window: slice the resolved
        # per-chromosome CSR (no per-node numpy calls or concatenations)
        lens = tbl_off[cand + 1] - tbl_off[cand]
        if lens.sum() > 0:
            flat_rows = _csr_flat(tbl_off, cand)
            flat_idx = tbl_idx[flat_rows]
            node_of = np.repeat(np.arange(n, dtype=np.int64), lens)
            all_local = tbl_lp[flat_rows]
            from ..ops.table import unpack_hapbits

            rows_flat = unpack_hapbits(hap_words[flat_idx], nhap)
            keep_flat = rows_flat[:, self.top_hap].any(axis=1)
            act_flat = flat_idx[keep_flat]
            act_node = node_of[keep_flat]
            counts = np.bincount(act_node, minlength=n)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            pos = np.arange(len(act_flat), dtype=np.int64) - offs[act_node]
            self.kind[counts == 0] = 2
            self.c[act_node, pos] = cov_u8[act_flat]
            self.f[act_node, pos] = freq_np[act_flat]
            self.flag[act_node, pos] = refflag[act_flat]
            self.kmask[act_node, pos] = True
            self.bits_u[act_node, pos] = rows_flat[keep_flat][:, self.used_haps]
            unpacked = np.unpackbits(
                all_local[keep_flat], axis=1, bitorder="little"
            )
            self.local_u[act_node, pos] = unpacked[:, self.used_haps]
        else:
            self.kind[:] = 2

        # distances between chain nodes (resets update anchors but do not
        # score -- genotype.cpp:371-374); vectorized shift instead of a
        # per-node loop
        dist_f = np.zeros(n, np.int64)
        dist_b = np.zeros(n, np.int64)
        if n:
            dist_f[0] = starts[0] & 0xFFFFFFFF
            dist_f[1:] = (starts[1:] - ends[:-1]) & 0xFFFFFFFF
            dist_b[n - 1] = (-ends[n - 1]) & 0xFFFFFFFF
            dist_b[:-1] = (starts[1:] - ends[:-1]) & 0xFFFFFFFF
        self.log_rec_f, self.log_norec_f = _transition_logs(dist_f, nhap)
        self.log_rec_b, self.log_norec_b = _transition_logs(dist_b, nhap)

        hap2u = {hp: i for i, hp in enumerate(self.used_haps)}
        self.state_u = np.array(
            [[hap2u[h] for h in s] for s in self.states], np.int32
        )
        with np.errstate(divide="ignore"):
            self.log_w = np.array(
                [
                    sum(math.log(self.score_map[h]) if self.score_map.get(h, 0) > 0
                        else -np.inf for h in s)
                    for s in self.states
                ],
                np.float32,
            )


def state_overlap(states: list[list[int]]) -> np.ndarray:
    """[S, S] int32 state-overlap matrix: the |multiset intersection| of
    each pair of haplotype combos (genotype.cpp:1217-1227), the sum over
    haplotypes of min(count_i, count_j)."""
    haps = sorted({h for s in states for h in s})
    hap_pos = {h: i for i, h in enumerate(haps)}
    cnt = np.zeros((len(states), len(hap_pos)), np.int32)
    for si, st in enumerate(states):
        for h in st:
            cnt[si, hap_pos[h]] += 1
    return np.minimum(cnt[:, None, :], cnt[None, :, :]).sum(axis=2,
                                                           dtype=np.int32)


def _posterior_string_fallback(rec_out, prep, post, node, nak_u, cak_num_u,
                               uk: int, hap2u: dict):
    """Exact string-keyed genotype aggregation (genotype.cpp:1441-1513) for
    nodes carrying GT values >= 10, where packed numeric keys would diverge
    from std::map's lexicographic string order."""
    hap_gt = node.hap_gt
    geno_strs = [
        "/".join(sorted(str(hap_gt[h]) for h in st)) for st in prep.states
    ]
    geno_sum: dict[str, float] = {}
    for si, gs in enumerate(geno_strs):
        geno_sum[gs] = geno_sum.get(gs, 0.0) + post[si]
    best_g, best_score = None, -1.0
    for gs in sorted(geno_sum.keys()):
        if geno_sum[gs] > best_score:
            best_score = geno_sum[gs]
            best_g = gs
    max_post = 0.0
    for si, gs in enumerate(geno_strs):
        if gs != best_g:
            continue
        rec_out.probability = float(best_score)
        if max_post < post[si]:
            max_post = post[si]
            rec_out.hap_vec = list(prep.states[si])
            rec_out.kmer_num_vec = []
            rec_out.kmer_avecov_vec = []
            for hp in rec_out.hap_vec:
                uj = hap2u[hp]
                num = int(nak_u[uj])
                rec_out.kmer_num_vec.append(num)
                rec_out.kmer_avecov_vec.append(
                    float(cak_num_u[uj]) / num if num else 0.0
                )
            rec_out.uk = uk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _forward_backward_mesh(mesh: Mesh, logE, *args, fre_mode: bool, P: int):
    """``_forward_backward`` with the window axis split over the mesh
    devices in contiguous slices of ceil(W / mesh size) windows; alpha and
    beta come back to the host."""
    W = logE.shape[0]
    step = -(-W // mesh.size)
    parts = [
        _forward_backward(logE[lo:lo + step].to(d),
                          *(a[lo:lo + step].to(d) for a in args), fre_mode, P)
        for d, lo in zip(mesh.devices, range(0, W, step))
    ]
    return (np.concatenate([a.cpu().numpy() for a, _ in parts]),
            np.concatenate([b.cpu().numpy() for _, b in parts]))


def genotype_torch(gi: GraphIndex, cfg, hap_cov: float, seed: int,
                   host_arrays=None, device: torch.device | str | None = None,
                   mesh: Mesh | None = None,
                   ) -> dict[tuple[str, int], PosteriorRecord]:
    """Score every window; returns {(chrom, start): PosteriorRecord}.

    device: where emissions and forward/backward run (default: the table's
    device).  mesh: with more than one device, each group's forward/backward
    is split over its devices by window.  In a multi-process run this
    process scores every n-th window and the results of all processes are
    merged.  Windows are scored in groups of up to _WINDOW_GROUP; each
    group is padded only to its own largest window, state count and
    used-hap count (U a multiple of 32, so hap bits pack into u32 words)."""
    device = torch.device(device) if device is not None else gi.table.device
    _t = {"prep": 0.0, "assemble": 0.0, "emit": 0.0, "fb": 0.0, "post": 0.0,
          "emit_upload": 0.0, "emit_device": 0.0}
    if host_arrays is not None:
        cov_u8, freq_np, hap_words, refflag = host_arrays
    else:
        cov_u8 = gi.table.cov_u8()
        freq_np = gi.table.freq_np()
        hap_words = gi.table.hap_words_np()
        refflag = gi.table.refflag_np()

    # geometric-model scalars
    p = get_error_param(float(np.float32(hap_cov)))
    q = 1.0 - p
    variance = 0.05
    log_prior = float(
        np.log(1.0 / np.sqrt(2 * np.pi * variance))
        - (p - 0.5) ** 2 / (2 * variance)
    )

    windows_all: list[tuple[str, int, int, int]] = []
    for chrom in sorted(gi.graph.nodes.keys()):
        starts = gi.graph.starts[chrom]
        chrom_len = gi.chrom_lens.get(chrom)
        if chrom_len is None:
            raise ValueError(f"'{chrom}' does not exist in the reference genome.")
        for w_id, (lo, hi) in enumerate(
            make_windows(starts, chrom_len, cfg.granularity_bp)
        ):
            windows_all.append((chrom, w_id, lo, hi))

    results: dict[tuple[str, int], PosteriorRecord] = {}
    if not windows_all:
        return results

    # several processes: each preps and scores its round-robin share of the
    # windows.  A window's result does not depend on which others share its
    # group (its RNG is seeded by (seed, chrom, w_id)), so the merged
    # results equal a single process's.
    n_proc = dist.process_count()
    windows_mine = windows_all
    if n_proc > 1:
        pid = dist.process_index()
        windows_mine = windows_all[pid::n_proc]
        log(f"window-sharded scoring: process {pid}/{n_proc} scores "
            f"{len(windows_mine)}/{len(windows_all)} windows",
            func="genotype_torch")
    if mesh is not None and mesh.size > 1:
        log(f"window-sharded forward/backward over {mesh.size} devices",
            func="genotype_torch")
    else:
        mesh = None

    def prep_iter():
        for chrom, w_id, lo, hi in windows_mine:
            rng = np.random.Generator(
                np.random.PCG64([seed, window_rng_seed(chrom), w_id])
            )
            prep = _WindowPrep(gi, cfg, chrom, lo, hi, rng, cov_u8, freq_np,
                               hap_words, refflag, hap_cov)
            starts = gi.graph.starts[chrom]
            log(
                f"Haplotype selection results for {chrom}-"
                f"{starts[lo] if lo < len(starts) else 0}: "
                + ", ".join(str(h) for h in prep.top_hap),
                func="haplotype_selection",
            )
            if prep.node_refs:
                yield prep

    K = MAX_NODE_KMERS
    P = cfg.sample_ploidy
    fre_mode = cfg.transition_pro_type != "rec"

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    # window prep runs one group ahead on a worker thread, and the host
    # posterior of a group overlaps the next group's device work
    it = prep_iter()
    pool = ThreadPoolExecutor(max_workers=1)
    post_pool = ThreadPoolExecutor(max_workers=1)
    post_fut = None

    def take():
        return list(itertools.islice(it, _WINDOW_GROUP))

    try:
        fut = pool.submit(take)
        while True:
            _tw = time.perf_counter()
            group = fut.result()       # only the NON-overlapped prep time counts
            _t["prep"] += time.perf_counter() - _tw
            if not group:
                break
            fut = pool.submit(take)
            _ta = time.perf_counter()
            G = len(group)
            N = max(len(p_.node_refs) for p_ in group)
            S = max(len(p_.states) for p_ in group)
            U = 32 * -(-max(len(p_.used_haps) for p_ in group) // 32)
            Ww = U // 32
            kind_all = np.zeros((G, N), np.int32)
            lrf = np.zeros((G, N), np.float32)
            lnrf = np.zeros((G, N), np.float32)
            lrb = np.zeros((G, N), np.float32)
            lnrb = np.zeros((G, N), np.float32)
            ov_all = np.zeros((G, S, S), np.int32)
            lw_all = np.zeros((G, S), np.float32)
            sm_all = np.zeros((G, S), bool)
            c_all = np.zeros((G, N, K), np.uint8)
            f_all = np.zeros((G, N, K), np.uint8)
            flag_all = np.zeros((G, N, K), bool)
            kmask_all = np.zeros((G, N, K), bool)
            bits_all = np.zeros((G, N, K, Ww), np.uint32)
            local_all = np.zeros((G, N, K, Ww), np.uint32)
            gt0_all = np.zeros((G, N, U), bool)
            su_all = np.zeros((G, S, P), np.int32)
            for wi, prep in enumerate(group):
                n = len(prep.node_refs)
                s = len(prep.states)
                bp = pack_hapbits(prep.bits_u.reshape(n * K, -1)).reshape(n, K, -1)
                lp = pack_hapbits(prep.local_u.reshape(n * K, -1)).reshape(n, K, -1)
                bits_all[wi, :n, :, : bp.shape[2]] = bp
                local_all[wi, :n, :, : lp.shape[2]] = lp
                gt0_all[wi, :n, : prep.gt0_u.shape[1]] = prep.gt0_u
                su_all[wi, :s] = prep.state_u
                c_all[wi, :n] = prep.c
                f_all[wi, :n] = prep.f
                flag_all[wi, :n] = prep.flag
                kmask_all[wi, :n] = prep.kmask
                kind_all[wi, :n] = prep.kind
                lrf[wi, :n] = prep.log_rec_f
                lnrf[wi, :n] = prep.log_norec_f
                lrb[wi, :n] = prep.log_rec_b
                lnrb[wi, :n] = prep.log_norec_b
                ov_all[wi, :s, :s] = prep.overlap
                lw_all[wi, :s] = prep.log_w
                sm_all[wi, :s] = True
            _t["assemble"] += time.perf_counter() - _ta

            # emissions into logE through emissions_: on the card the kernel,
            # which holds no intermediate, so a group is one launch (a window
            # chunk a launch where the group's inputs exceed
            # _EMIT_UPLOAD_BYTES); on the CPU the plain torch body, with
            # windows (and, for a window above _EMIT_ROWS nodes, node chunks)
            # as a batch dimension bounding its [rows, K, S] intermediates
            _te = time.perf_counter()
            lo_w, up_w = group[0].lower, group[0].upper  # same for all windows
            # float32 values, as the JAX engine computes them
            scalars = tuple(float(np.float32(x)) for x in (
                hap_cov, lo_w, up_w, np.log(p), np.log(q), log_prior))
            if device.type == "cuda":
                row_bytes = N * (K * (4 + 8 * Ww) + U)
                gc, nc = max(1, _EMIT_UPLOAD_BYTES // row_bytes), N
            elif N <= _EMIT_ROWS:
                gc, nc = max(1, _EMIT_ROWS // N), N
            else:
                gc, nc = 1, _NODE_CHUNK
            su_d = dev(su_all)
            sm_d = dev(sm_all)
            logE = torch.empty((G, N, S), dtype=torch.float32, device=device)
            # each chunk's upload and device compute are timed apart
            # (synchronized)
            for g0 in range(0, G, gc):
                g1 = g0 + gc
                for n0 in range(0, N, nc):
                    n1 = n0 + nc
                    _tu = time.perf_counter()
                    # the host dtypes: u8 counts, bool flags, u32 words as int32
                    inputs = tuple(dev(a[g0:g1, n0:n1]) for a in (
                        c_all, f_all, flag_all, kmask_all,
                        bits_all.view(np.int32), local_all.view(np.int32),
                        gt0_all))
                    _sync(device)
                    _tc = time.perf_counter()
                    _t["emit_upload"] += _tc - _tu
                    whole = n0 == 0 and n1 >= N
                    out = (logE[g0:g1] if whole else torch.empty(
                        inputs[0].shape[:2] + (S,), dtype=torch.float32,
                        device=device))
                    emissions_(out, *inputs, su_d[g0:g1], sm_d[g0:g1], *scalars)
                    if not whole:
                        logE[g0:g1, n0:n1] = out
                    _sync(device)
                    _t["emit_device"] += time.perf_counter() - _tc
            _t["emit"] += time.perf_counter() - _te

            _tf = time.perf_counter()
            fb_args = (dev(kind_all), dev(lrf), dev(lnrf), dev(lrb), dev(lnrb),
                       dev(ov_all), dev(lw_all), sm_d)
            if mesh is not None:
                alpha, beta = _forward_backward_mesh(
                    mesh, logE, *fb_args, fre_mode=fre_mode, P=P)
            else:
                alpha, beta = _forward_backward(logE, *fb_args, fre_mode, P)
                alpha = alpha.cpu().numpy()
                beta = beta.cpu().numpy()
            _t["fb"] += time.perf_counter() - _tf

            _tp = time.perf_counter()
            if post_fut is not None:
                post_fut.result()
                _t["post"] += time.perf_counter() - _tp
            post_fut = post_pool.submit(
                _posterior_window_group, group, alpha, beta, results
            )

        _tp = time.perf_counter()
        if post_fut is not None:
            post_fut.result()
        _t["post"] += time.perf_counter() - _tp
    finally:
        pool.shutdown(wait=True)
        post_pool.shutdown(wait=True)
    log(
        "engine timing: prep {prep:.2f}s assemble {assemble:.2f}s emit "
        "{emit:.2f}s fb {fb:.2f}s "
        "posterior {post:.2f}s (non-overlapped); emit upload "
        "{emit_upload:.3f}s emit device {emit_device:.3f}s".format(**_t),
        func="genotype_torch",
    )
    if n_proc > 1:
        results = dist.merge_results_across_hosts(results)
    return results


def _posterior_window_group(group, alpha, beta, results):
    # ---- posterior on host (genotype.cpp:1371-1546), vectorized per window ----
    # Genotype grouping uses string-sorted keys in the reference
    # (std::map<string>, genotype.cpp:1441-1459).  For GT values <= 9 the
    # string order of "a/b/..." (digits sorted ascending) equals the
    # lexicographic order of the ascending-sorted numeric tuples, so groups
    # are formed with packed integer keys; rare nodes carrying GT >= 10 fall
    # back to the exact string path.
    for wi, prep in enumerate(group):
        s = len(prep.states)
        n = len(prep.node_refs)
        if n == 0:
            continue
        real = prep.kind == 1
        a = alpha[wi, :n, :s].astype(np.float64)
        b = beta[wi, :n, :s].astype(np.float64)
        ab = a * b
        den = ab.sum(axis=1)
        safe_den = np.where(den != 0, den, 1.0)
        post = np.where((den != 0)[:, None], ab / safe_den[:, None], 0.0)

        # per-node GT values of the used haplotypes [n, U], gathered once
        # from the per-chrom GT matrix during prep
        G_nsp = prep.G_nu[:, prep.state_u]          # [n, S, P]
        fallback = (G_nsp.max(axis=(1, 2)) > 9) & real

        P = prep.state_u.shape[1]
        gts_sorted = np.sort(G_nsp, axis=2)          # ascending == sorted(str) for <=9
        shifts = (8 * np.arange(P - 1, -1, -1)).astype(np.int64)
        keys_ns = (gts_sorted << shifts).sum(axis=2)  # [n, S]

        # group-by per node: stable sort by key, segment sums, best = max
        # score with smallest key on ties (ascending scan with strict >)
        order = np.argsort(keys_ns, axis=1, kind="stable")
        ksort = np.take_along_axis(keys_ns, order, axis=1)
        psort = np.take_along_axis(post, order, axis=1)
        gstart = np.ones((n, s), bool)
        gstart[:, 1:] = ksort[:, 1:] != ksort[:, :-1]
        gid = np.cumsum(gstart, axis=1) - 1           # group index per position
        last_in_group = np.ones((n, s), bool)
        last_in_group[:, :-1] = gstart[:, 1:]
        csum = np.cumsum(psort, axis=1)
        # csum value just before each group's start, forward-filled within
        # the group (csum is nondecreasing, so maximum.accumulate fills)
        shifted = np.zeros_like(csum)
        shifted[:, 1:] = csum[:, :-1]
        base = np.maximum.accumulate(
            np.where(gstart, shifted, -np.inf), axis=1
        )
        totals_end = np.where(last_in_group, csum - base, -np.inf)  # [n, s]
        best_score_n = totals_end.max(axis=1)
        # first group (smallest key) achieving the max
        win_pos = np.argmax(totals_end == best_score_n[:, None], axis=1)
        win_group = np.take_along_axis(gid, win_pos[:, None], axis=1)[:, 0]

        # winner state: first (by si) strictly-max post among winner-group
        # states, matching `if max_post < post[si]` with max_post starting 0
        in_win = gid == win_group[:, None]            # positions in sorted order
        win_mask = np.zeros((n, s), bool)             # by original si
        np.put_along_axis(win_mask, order, in_win, axis=1)
        post_w = np.where(win_mask, post, -np.inf)
        max_post_n = post_w.max(axis=1)
        win_si = np.argmax(post_w == max_post_n[:, None], axis=1)
        has_winner = max_post_n > 0.0

        # NAK/CAK/UK, vectorized over the prep tensors
        nak_nu = (prep.bits_u * prep.kmask[:, :, None]).sum(axis=1)   # [n, U]
        cak_num = (prep.c[:, :, None] * prep.bits_u
                   * prep.kmask[:, :, None]).sum(axis=1)              # [n, U]
        uk_n = np.minimum(((prep.f <= 1) & prep.kmask).sum(axis=1), 255)

        hap2u = {hp: uj for uj, hp in enumerate(prep.used_haps)}
        for ni, node in enumerate(prep.node_refs):
            if not real[ni]:
                continue
            rec_out = PosteriorRecord()
            if fallback[ni]:
                _posterior_string_fallback(
                    rec_out, prep, post[ni], node, nak_nu[ni], cak_num[ni],
                    int(uk_n[ni]), hap2u,
                )
            else:
                rec_out.probability = float(best_score_n[ni])
                if has_winner[ni]:
                    si = int(win_si[ni])
                    rec_out.hap_vec = list(prep.states[si])
                    rec_out.kmer_num_vec = []
                    rec_out.kmer_avecov_vec = []
                    for hp in rec_out.hap_vec:
                        uj = hap2u[hp]
                        num = int(nak_nu[ni, uj])
                        rec_out.kmer_num_vec.append(num)
                        rec_out.kmer_avecov_vec.append(
                            float(cak_num[ni, uj]) / num if num else 0.0
                        )
                    rec_out.uk = int(uk_n[ni])
            results[(prep.chrom, node.start)] = rec_out