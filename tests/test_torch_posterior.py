"""The genotyping posterior: each real node's record from alpha and beta.

The plain version with the kernel's contract (varigraph_tpu_torch/ops/post.py
``posterior_plain``, the engine's vectorised float64 numpy a window at a
time), reached through the wrapper ``ops/post_cuda.posterior_`` on CPU
tensors, and the engine's records built from its rows
(``engine_torch._posterior_window_group``), must give the same
``PosteriorRecord``s as the engine's earlier posterior, which reduced host
alpha and beta window by window (a copy of it is frozen below as
``_parent_posterior_window``), over randomized windows: P = 1, 2, 3, 4 and
8, S = 1, ties of equal group sums, ties of equal post in the winner group,
rows whose sum of alpha·beta is 0, reset (kind 2) rows, nodes with no valid
k-mer, and nodes with a GT of 10 or more, which take the string-keyed path
from their alpha and beta rows.  The card path's host side
(``engine_torch._posterior_on_card``: the rows copied, the fallback nodes'
alpha and beta rows picked, the launches' cover of the group, the counters)
runs here on CPU tensors through the plain version, and the mesh's
forward/backward gathers alpha and beta on the group's device.

On the card (marked ``cuda``): the kernel csrc/post.cu against the plain
version on the same calls, bit for bit: the winner state (so ``hap_vec``),
NAK, CAK, UK, the fallback flags and ``probability`` (the kernel takes each
float64 sum in numpy's order: the printed GQ reads 1 - GPP, where an ulp
near 1 shows), at S = 120, 465, 1,024 and
2,080, P = 1, 2, 4 and 8, S = 1, and on sixteenths, where ties of key sums
and of post abound; bit for bit run to run and wherever a window sits in
the group; one launch a call.  The numpy row sum that the kernel follows
(pairwise, from 0) and running sum (cumsum, in order) are checked against
their emulations here.  The card's cases
run with
    python -m pytest --noconftest -m cuda tests/test_torch_posterior.py
"""

import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import PosteriorRecord  # noqa: E402
from varigraph_tpu_torch.ops import post_cuda  # noqa: E402
from varigraph_tpu_torch.ops.post import (  # noqa: E402
    FALLBACK, NAK, NO_WINNER, UK, WINNER, probabilities, row_width)
from varigraph_tpu_torch.ops.table import pack_hapbits  # noqa: E402
from varigraph_tpu_torch.utils import timing  # noqa: E402

# --------------------------------------------- the parent's posterior, frozen

def _parent_string_fallback(rec_out, prep, post, node, nak_u, cak_num_u,
                            uk: int, hap2u: dict):
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


def _parent_posterior_window(prep, alpha_w, beta_w, results):
    s = len(prep.states)
    n = len(prep.node_refs)
    if n == 0:
        return
    real = prep.kind == 1
    a = alpha_w[:n, :s].astype(np.float64)
    b = beta_w[:n, :s].astype(np.float64)
    ab = a * b
    den = ab.sum(axis=1)
    safe_den = np.where(den != 0, den, 1.0)
    post = np.where((den != 0)[:, None], ab / safe_den[:, None], 0.0)
    G_nsp = prep.G_nu[:, prep.state_u]
    fallback = (G_nsp.max(axis=(1, 2)) > 9) & real
    P = prep.state_u.shape[1]
    gts_sorted = np.sort(G_nsp, axis=2)
    shifts = (8 * np.arange(P - 1, -1, -1)).astype(np.int64)
    keys_ns = (gts_sorted << shifts).sum(axis=2)
    order = np.argsort(keys_ns, axis=1, kind="stable")
    ksort = np.take_along_axis(keys_ns, order, axis=1)
    psort = np.take_along_axis(post, order, axis=1)
    gstart = np.ones((n, s), bool)
    gstart[:, 1:] = ksort[:, 1:] != ksort[:, :-1]
    gid = np.cumsum(gstart, axis=1) - 1
    last_in_group = np.ones((n, s), bool)
    last_in_group[:, :-1] = gstart[:, 1:]
    csum = np.cumsum(psort, axis=1)
    shifted = np.zeros_like(csum)
    shifted[:, 1:] = csum[:, :-1]
    base = np.maximum.accumulate(np.where(gstart, shifted, -np.inf), axis=1)
    totals_end = np.where(last_in_group, csum - base, -np.inf)
    best_score_n = totals_end.max(axis=1)
    win_pos = np.argmax(totals_end == best_score_n[:, None], axis=1)
    win_group = np.take_along_axis(gid, win_pos[:, None], axis=1)[:, 0]
    in_win = gid == win_group[:, None]
    win_mask = np.zeros((n, s), bool)
    np.put_along_axis(win_mask, order, in_win, axis=1)
    post_w = np.where(win_mask, post, -np.inf)
    max_post_n = post_w.max(axis=1)
    win_si = np.argmax(post_w == max_post_n[:, None], axis=1)
    has_winner = max_post_n > 0.0
    nak_nu = (prep.bits_u * prep.kmask[:, :, None]).sum(axis=1)
    cak_num = (prep.c[:, :, None] * prep.bits_u
               * prep.kmask[:, :, None]).sum(axis=1)
    uk_n = np.minimum(((prep.f <= 1) & prep.kmask).sum(axis=1), 255)
    hap2u = {hp: uj for uj, hp in enumerate(prep.used_haps)}
    for ni, node in enumerate(prep.node_refs):
        if not real[ni]:
            continue
        rec_out = PosteriorRecord()
        if fallback[ni]:
            _parent_string_fallback(
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


# ------------------------------------------------------------ the windows

def make_window(seed, n=40, S=12, P=2, K=16, nhap=70, gt_max=2, chrom="chr1",
                fallback_share=0.0, zero_share=0.1, reset_share=0.1,
                empty_share=0.1, dyadic=False):
    """A random window as the engine's prep holds it: states of P used haps,
    nodes with their GT vectors, k-mer rows, and alpha, beta [n, S]."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(nhap, size=min(nhap, max(P, S)), replace=False)
    states = [sorted(int(h) for h in rng.choice(pool, P)) for _ in range(S)]
    used = sorted({h for st in states for h in st})
    hap2u = {h: i for i, h in enumerate(used)}
    hap_gt = rng.integers(0, gt_max + 1, (n, nhap)).astype(np.uint16)
    fb = rng.random(n) < fallback_share
    hap_gt[fb, used[0]] = rng.integers(10, 13, int(fb.sum()))
    kind = np.where(rng.random(n) < reset_share, 2, 1).astype(np.int32)
    kmask = rng.random((n, K)) < 0.7
    kmask[rng.random(n) < empty_share] = False
    U = len(used)
    bits_u = (rng.random((n, K, U)) < 0.5).astype(np.uint8)
    c = rng.integers(0, 256, (n, K)).astype(np.int32)
    f = rng.integers(0, 6, (n, K)).astype(np.int32)
    if dyadic:      # sixteenths summing to 1: every sum is exact, ties abound
        alpha = (rng.multinomial(16, np.full(S, 1 / S), size=n) / 16).astype(np.float32)
        beta = np.ones((n, S), np.float32)
    else:
        alpha = np.exp(rng.normal(0, 3, (n, S))).astype(np.float32)
        beta = np.exp(rng.normal(0, 3, (n, S))).astype(np.float32)
        alpha /= alpha.sum(axis=1, keepdims=True)
        beta /= beta.sum(axis=1, keepdims=True)
    alpha[rng.random(n) < zero_share] = 0.0
    return types.SimpleNamespace(
        chrom=chrom, states=states, used_haps=used,
        state_u=np.array([[hap2u[h] for h in st] for st in states], np.int32),
        node_refs=[types.SimpleNamespace(start=1000 * seed + 10 * i, hap_gt=hap_gt[i])
                   for i in range(n)],
        G_nu=hap_gt[:, used].astype(np.int64), kind=kind, c=c, f=f,
        kmask=kmask, bits_u=bits_u, alpha=alpha, beta=beta)


def group_arrays(group):
    """The posterior's inputs for a group of windows, padded as the engine
    pads them: (alpha, beta, kind, gt, state_u, smask, c, f, kmask, bits)."""
    G = len(group)
    N = max(len(w.node_refs) for w in group)
    S = max(len(w.states) for w in group)
    P = group[0].state_u.shape[1]
    K = group[0].c.shape[1]
    U = 32 * -(-max(len(w.used_haps) for w in group) // 32)
    alpha = np.zeros((G, N, S), np.float32)
    beta = np.zeros((G, N, S), np.float32)
    kind = np.zeros((G, N), np.int32)
    gt = np.zeros((G, N, U), np.uint8)
    su = np.zeros((G, S, P), np.int32)
    sm = np.zeros((G, S), bool)
    c = np.zeros((G, N, K), np.uint8)
    f = np.zeros((G, N, K), np.uint8)
    kmask = np.zeros((G, N, K), bool)
    bits = np.zeros((G, N, K, U // 32), np.uint32)
    for g, w in enumerate(group):
        n, s = len(w.node_refs), len(w.states)
        alpha[g, :n, :s], beta[g, :n, :s] = w.alpha, w.beta
        kind[g, :n] = w.kind
        gt[g, :n, :w.G_nu.shape[1]] = np.minimum(w.G_nu, 255)
        su[g, :s], sm[g, :s] = w.state_u, True
        c[g, :n], f[g, :n], kmask[g, :n] = w.c, w.f, w.kmask
        bp = pack_hapbits(w.bits_u.reshape(n * K, -1)).reshape(n, K, -1)
        bits[g, :n, :, :bp.shape[2]] = bp
    return alpha, beta, kind, gt, su, sm, c, f, kmask, bits.view(np.int32)


def _tensors(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _empty(arrays, device="cpu"):
    G, N, _ = arrays[0].shape
    P = arrays[4].shape[2]
    return torch.empty((G, N, row_width(P)), dtype=torch.int32, device=device)


def parent_records(group):
    want = {}
    for w in group:
        _parent_posterior_window(w, w.alpha, w.beta, want)
    return want


def plain_records(group):
    """The engine's CPU path: each window's posterior_ in the worker, then
    its records."""
    arrays = group_arrays(group)
    G, N, S = arrays[0].shape
    out = np.empty((G, N, row_width(arrays[4].shape[2])), np.int32)
    got = {}
    et._posterior_window_group(group, out, list(zip(arrays[0], arrays[1])), got,
                               plain=_tensors(arrays))
    return got


def assert_same_records(got, want):
    assert set(got) == set(want) and want
    for k in want:
        assert got[k] == want[k], k


WINDOW_CASES = {
    "p2": dict(P=2),
    "p1": dict(P=1, S=5),
    "p3": dict(P=3, S=20),
    "p4": dict(P=4, S=30, gt_max=3),
    "p8": dict(P=8, S=40, gt_max=9),
    "s1": dict(S=1),
    "digits": dict(gt_max=9, S=30),
    "fallback": dict(fallback_share=0.3, gt_max=3),
    "fallback_p4": dict(P=4, S=25, fallback_share=0.3),
    "all_zero": dict(zero_share=1.0),
    "no_kmers": dict(empty_share=1.0),
    "resets": dict(reset_share=0.6),
    "dyadic_ties": dict(dyadic=True, S=16, gt_max=1),
    "wide_k": dict(K=128, S=20, nhap=90),
}


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_plain_matches_the_parent_posterior(name):
    group = [make_window(10 + i, chrom=f"c{i}", **WINDOW_CASES[name])
             for i in range(3)]
    # a smaller last window: node and state padding in the group
    group.append(make_window(20, n=7, chrom="c9", **{**WINDOW_CASES[name],
                                                     "S": max(1, WINDOW_CASES[name].get("S", 12) // 2)}))
    assert_same_records(plain_records(group), parent_records(group))


def _tie_window(P=2):
    """Four states of the haps 0 and 1 ([0,0] [0,1] [0,1] [1,1] at P = 2):
    node 0 has two keys of equal sums (the smaller key must win), node 1 two
    states of equal post in the winning key (the first must win), node 2
    Σ alpha·beta = 0, node 3 both.  Every sum is exact."""
    w = make_window(3, n=4, S=4, P=P, K=8, zero_share=0, reset_share=0,
                    empty_share=0)
    w.states = [[0] * P, [0] * (P - 1) + [1], [0] * (P - 1) + [1], [1] * P]
    w.used_haps = [0, 1]
    w.state_u = np.array(w.states, np.int32)
    gt = np.zeros((4, 70), np.uint16)
    gt[:, 1] = 1
    for i, nd in enumerate(w.node_refs):
        nd.hap_gt = gt[i]
    w.G_nu = gt[:, :2].astype(np.int64)
    w.bits_u = np.random.default_rng(0).integers(0, 2, (4, 8, 2)).astype(np.uint8)
    w.alpha = np.array([[0.5, 0.25, 0.25, 0.0],     # keys 00 and 01 tie
                        [0.0, 0.375, 0.375, 0.25],  # 01 wins, si 1 and 2 tie
                        [0.0, 0.0, 0.0, 0.0],
                        [0.25, 0.125, 0.125, 0.5]], np.float32)
    w.beta = np.ones((4, 4), np.float32)
    return w


@pytest.mark.parametrize("P", [1, 2, 3])
def test_ties_and_zero_rows_match_the_parent(P):
    group = [_tie_window(P)]
    got = plain_records(group)
    assert_same_records(got, parent_records(group))
    recs = [got[("chr1", nd.start)] for nd in group[0].node_refs]
    if P > 1:
        assert recs[0].hap_vec == [0] * P             # the smaller key of a tie
        assert recs[1].hap_vec == [0] * (P - 1) + [1]  # the first of equal post
    assert recs[2].hap_vec == [] and recs[2].probability == 0.0


def test_the_card_paths_host_side_matches_the_parent(monkeypatch):
    """``_posterior_on_card`` on CPU tensors (the plain version in the
    kernel's place): the rows copied, the fallback nodes' alpha and beta
    rows picked by node, the counters."""
    group = [make_window(30 + i, chrom=f"c{i}", fallback_share=0.2)
             for i in range(3)]
    arrays = group_arrays(group)
    a, b, kind, gt, su, sm, c, f, kmask, bits = _tensors(arrays)
    before = timing.counters()
    # two launches, as two emissions launches of one and two windows
    kept = [(0, 1, c[0:1], f[0:1], kmask[0:1], bits[0:1]),
            (1, 3, c[1:3], f[1:3], kmask[1:3], bits[1:3])]
    out, chains, kind_host = et._posterior_on_card(a, b, kind, gt, su, sm, kept)
    moved = timing.counters_since(before)
    assert np.array_equal(kind_host, arrays[2])
    got = {}
    et._posterior_window_group(group, out, chains, got)
    assert_same_records(got, parent_records(group))
    n_fb = sum(len(ca) for ca, *_ in chains)
    assert n_fb == int((out[..., WINNER] == FALLBACK).sum()) > 0
    for g, rows in enumerate(chains):
        fallback = set(np.nonzero(out[g, :, WINNER] == FALLBACK)[0])
        assert all(set(r) == fallback for r in rows)
        # alpha, beta and the node's k-mer rows: c, kmask, bits
        for r, j in zip(rows, (0, 1, 6, 8, 9)):
            for n in r:
                assert np.array_equal(r[n], arrays[j][g, n])
    assert moved["post.fallback_nodes"] == n_fb
    assert moved["post.card_nodes"] == int((arrays[2] == 1).sum()) - n_fb
    assert moved["post.plain_windows"] == 3        # the plain stand-in


@pytest.mark.parametrize("cover", [[(0, 1)], [(1, 3)], [(0, 1), (2, 3)], []])
def test_launches_that_miss_a_window_are_an_error(cover):
    """Kept launches that leave a window of the group out raise, where the
    window's rows would be left unwritten."""
    arrays = group_arrays([make_window(80 + i, chrom=f"c{i}") for i in range(3)])
    a, b, kind, gt, su, sm, c, f, kmask, bits = _tensors(arrays)
    kept = [(g0, g1, c[g0:g1], f[g0:g1], kmask[g0:g1], bits[g0:g1])
            for g0, g1 in cover]
    with pytest.raises(RuntimeError, match="do not cover the group"):
        et._posterior_on_card(a, b, kind, gt, su, sm, kept)


def test_the_mesh_gathers_alpha_and_beta_on_the_groups_device(monkeypatch):
    """The mesh's forward/backward returns tensors on logE's device, its
    parts in window order, so the posterior follows alpha's device."""
    def fake_fb(logE, kind, *rest):
        return logE + kind[..., None], logE * 2
    monkeypatch.setattr(et, "_forward_backward", fake_fb)
    logE = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    kind = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    alpha, beta = et._forward_backward_mesh(et.Mesh(["cpu"] * 2), logE, kind,
                                            fre_mode=True, P=2)
    assert isinstance(alpha, torch.Tensor) and alpha.device == logE.device
    assert torch.equal(alpha, logE + kind[..., None])
    assert torch.equal(beta, logE * 2)


def test_the_rows_layout():
    group = [make_window(7, fallback_share=0.2)]
    arrays = group_arrays(group)
    out = _empty(arrays)
    post_cuda.posterior_(out, *_tensors(arrays))
    o = out.numpy()[0]
    w = group[0]
    real = w.kind == 1
    assert (o[~real, WINNER] == NO_WINNER).all() and (o[~real, UK:] == 0).all()
    assert (probabilities(o)[~real] == 0).all()
    assert (o[real, UK] == np.minimum(((w.f <= 1) & w.kmask).sum(1), 255)[real]).all()
    won = o[:, WINNER] >= 0
    assert won.any() and (o[won, NAK:NAK + 2] <= w.kmask.sum(1)[won, None]).all()


def test_the_engine_counts_plain_windows_on_the_cpu():
    group = [make_window(40 + i, chrom=f"c{i}") for i in range(2)]
    before = timing.counters()
    plain_records(group)
    moved = timing.counters_since(before)
    assert moved["post.plain_windows"] == 2
    assert "post.card_nodes" not in moved and "launches.posterior" not in moved


# --------------------------------------------------------- argument checks

def _valid():
    arrays = group_arrays([make_window(1)])
    return [_empty(arrays)] + list(_tensors(arrays))


NAMES = ["out", "alpha", "beta", "kind", "gt", "state_u", "smask", "c", "f",
         "kmask", "bits"]


@pytest.mark.parametrize("i", range(len(NAMES)))
def test_wrong_dtype_is_an_error(i):
    args = _valid()
    args[i] = args[i].to(torch.int16 if args[i].dtype != torch.int16 else torch.int32)
    with pytest.raises(TypeError, match=NAMES[i]):
        post_cuda.posterior_(*args)


@pytest.mark.parametrize("i", [0, 2, 3, 4, 6, 7, 8, 9])
def test_wrong_shape_is_an_error(i):
    args = _valid()
    args[i] = args[i][..., :-1].contiguous() if args[i].dim() > 2 or i in (3, 6) \
        else args[i][:-1]
    with pytest.raises(ValueError, match=NAMES[i]):
        post_cuda.posterior_(*args)


def test_non_contiguous_and_non_tensor_are_errors():
    args = _valid()
    args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="beta must be contiguous"):
        post_cuda.posterior_(*args)
    args = _valid()
    args[3] = args[3].numpy()
    with pytest.raises(TypeError, match="kind"):
        post_cuda.posterior_(*args)


def test_ploidy_and_slots_are_checked():
    args = _valid()
    G, S, _ = args[5].shape
    args[5] = torch.zeros((G, S, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="P must be in 1..8"):
        post_cuda.posterior_(*args)
    args = _valid()
    args[5][0, 0, 0] = 32
    with pytest.raises(ValueError, match="slot is outside 0..31"):
        post_cuda.posterior_(*args)
    args = _valid()
    args[6][0, -1] = False                         # a masked state's slot
    args[5][0, -1, 0] = 99                         # is not read
    post_cuda.posterior_(*args)


def test_the_cpu_makes_no_launch_and_the_engine_calls_the_wrapper():
    before = post_cuda.LAUNCHES["posterior"]
    post_cuda.posterior_(*_valid())
    assert post_cuda.LAUNCHES["posterior"] == before
    assert et.posterior_ is post_cuda.posterior_


def _numpy_pairwise(a):
    """numpy's pairwise_sum, which the kernel's den follows: a block of up
    to 128 values as 8 strided partial sums, else the two halves cut at a
    multiple of 8."""
    n = len(a)
    if n <= 128:
        if n < 8:
            r = 0.0
            for x in a:
                r += x
            return r
        r, m8 = list(a[:8]), n - n % 8
        for i in range(8, m8, 8):
            for j in range(8):
                r[j] += a[i + j]
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for x in a[m8:]:
            res += x
        return res
    h = n // 2 - (n // 2) % 8
    return _numpy_pairwise(a[:h]) + _numpy_pairwise(a[h:])


@pytest.mark.parametrize("S", [1, 7, 8, 9, 120, 127, 128, 129, 136, 465, 1024, 2080])
def test_the_row_sum_the_kernel_follows_is_numpys(S):
    rng = np.random.default_rng(S)
    ab = np.exp(rng.normal(0, 8, (16, S))) * rng.random((16, S))
    want = ab.sum(axis=1)
    assert [_numpy_pairwise(list(r)) for r in ab] == want.tolist()
    # and a key's sum is a difference of cumsum's sequential running sum
    assert np.cumsum(ab, axis=1).tolist() == [list(itertools.accumulate(r.tolist()))
                                              for r in ab]


# ------------------------------------------------------------ on the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the posterior kernel has no CPU mode")


def _run(arrays, device):
    out = _empty(arrays, device)
    post_cuda.posterior_(out, *_tensors(arrays, device))
    if device == "cuda":
        torch.cuda.synchronize()
    return out.cpu().numpy()


CARD_CASES = {
    "S120": dict(S=120, P=2, n=300, K=128, nhap=65, fallback_share=0.02),
    "S465": dict(S=465, P=2, n=200, K=128, nhap=65),
    "S1024": dict(S=1024, P=2, n=60, K=128, nhap=65, gt_max=4),
    "S2080": dict(S=2080, P=2, n=30, K=128, nhap=130, gt_max=3),
    "P4": dict(S=330, P=4, n=120, K=128, nhap=90, gt_max=3, fallback_share=0.05),
    "P8": dict(S=200, P=8, n=60, K=64, nhap=101, gt_max=9),
    "P1": dict(S=7, P=1, n=50),
    "S1": dict(S=1, n=50),
    "dyadic_ties": dict(S=16, P=2, n=200, gt_max=1, dyadic=True),
    "S129": dict(S=129, P=2, n=100, K=128, nhap=65, gt_max=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_cuda_kernel_matches_plain(name):
    _need_card()
    group = [make_window(50 + i, chrom=f"c{i}", **CARD_CASES[name]) for i in range(3)]
    arrays = group_arrays(group)
    before = post_cuda.LAUNCHES["posterior"]
    got = _run(arrays, "cuda")
    assert post_cuda.LAUNCHES["posterior"] == before + 1
    np.testing.assert_array_equal(got, _run(arrays, "cpu"))
    # run to run, bit for bit
    np.testing.assert_array_equal(_run(arrays, "cuda"), got)


@pytest.mark.cuda
def test_cuda_tie_window_matches_plain():
    _need_card()
    arrays = group_arrays([_tie_window(2), _tie_window(2)])
    np.testing.assert_array_equal(_run(arrays, "cuda"), _run(arrays, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["S120", "P4"])
def test_cuda_a_window_is_the_same_anywhere_in_the_group(name):
    """A window alone equals the same window as the fourth of six windows,
    bit for bit."""
    _need_card()
    w = make_window(60, **CARD_CASES[name])
    others = [make_window(61 + i, chrom=f"c{i}", **CARD_CASES[name]) for i in range(5)]
    alone = _run(group_arrays([w]), "cuda")
    inside = _run(group_arrays(others[:3] + [w] + others[3:]), "cuda")
    n = len(w.node_refs)
    np.testing.assert_array_equal(inside[3, :n], alone[0, :n])
