"""The forward/backward scan: alpha and beta of every window's HMM.

The port's plain version (varigraph_tpu_torch/genotype/engine_torch.py
``_forward_backward_plain``, ``_scan`` over the overlap-class masks) must
equal the JAX package's ``_forward_backward`` (varigraph_tpu/genotype/
engine_jax.py) at atol 1e-6 on the edge cases below: ploidy 2, 3, 4 and 8
(overlaps from ``increment_vector``'s polyploid combos and from random
multisets; at P = 8 also with 101 haplotypes' rare recombination, where
rec^k nears float32's smallest values), one state, one node, a window of
pad nodes only, resets at the first and last node, zero distances in both
directions, and overlaps that the kernel's class lists treat apart (dense
random classes, all class 0, all class P, a class above P, which weighs 0)
and a distance so large that rec = norec; rec and fre.  The wrapper
(ops/fb_cuda.forward_backward) runs the plain version on CPU tensors, and on
the card the CUDA kernel (csrc/fb.cu), which is held against the plain
version on the same cases, at S = 120, 253, 465 and 496 (lists in
registers), at S = 780 (one state a thread, lists in shared memory, and
with a dense overlap in device memory), at S = 1275, 2080 and 3081 and at
the most states a launch takes (the wide kernel, lists in device memory).
The kernel's rows are bit-identical run to run, and a window's whatever the
batch holds beside it, a window whose dense overlap sends the batch down
the list path included.  The kernel's per-column class lists
(ops/fb_cuda.fb_layout) are held against the overlap on the CPU, entry by
entry, and the flow summed from them against the dense per-class flow.

Tolerance: atol 1e-6 (about 8 ulp at 1.0) on the normalized alpha/beta,
values in [0, 1]: float32 sums taken in another order (per overlap class
and then over classes in the plain version, per state in the kernel, XLA's
own order in JAX); per-step normalization keeps the errors from growing.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu_torch.genotype.combos import increment_vector  # noqa: E402
from varigraph_tpu_torch.ops import fb_cuda  # noqa: E402

# The JAX side is imported inside the tests that use it: the machine with the
# card has no JAX, and runs the kernel cases of this file alone with
#   python -m pytest --noconftest -m cuda tests/test_torch_fb.py

ATOL = 1e-6
CASES = ["p2", "p3", "p4", "p8", "s1", "n1", "all_pad", "resets_at_ends",
         "zero_distances", "dense", "all_zero", "all_P", "above_P", "far",
         "p8_rare_rec"]
# cases whose overlap is rewritten after the states are drawn
OVERLAP_CASES = ("dense", "all_zero", "all_P", "above_P")


def _random_multisets(rng, S, P, nhap):
    return [sorted(rng.integers(0, nhap, P).tolist()) for _ in range(S)]


def _inputs(rng, W, N, overlaps, P):
    """Arrays of a batch of W windows of N nodes, window w with the states
    of overlaps[w] (padded to the largest S), random emissions and
    distances, every node real."""
    S = max(len(o) for o in overlaps)
    ov = np.zeros((W, S, S), np.int32)
    smask = np.zeros((W, S), bool)
    for w, o in enumerate(overlaps):
        ov[w, :len(o), :len(o)] = o
        smask[w, :len(o)] = True
    logE = rng.normal(-40.0, 6.0, size=(W, N, S)).astype(np.float32)
    logE[~np.broadcast_to(smask[:, None, :], logE.shape)] = -np.inf
    kind = np.ones((W, N), np.int32)
    dist = rng.integers(0, 200_000, size=(W, 2, N))
    w_ = rng.random((W, S))
    if S > 1:
        w_[0, 0] = 0.0                     # a state of zero frequency
    with np.errstate(divide="ignore"):
        log_w = np.log(w_ / w_.sum(axis=1, keepdims=True)).astype(np.float32)
    log_w[~smask] = 0.0
    return [logE, kind, dist, ov, log_w, smask]


def case_arrays(name: str, fre: bool, S=None):
    """(logE, kind, lrf, lnrf, lrb, lnrb, overlap, log_w, smask), P of one
    case; ``S`` sizes a P = 2 case from the first S diploid het states."""
    rng = np.random.default_rng(CASES.index(name) if name in CASES else S)
    P, W, N = 2, 3, 25
    if S is not None:
        nh = int((np.sqrt(8 * S + 1) - 1) / 2)
        full = et.state_overlap(
            increment_vector(list(range(nh + 1)), "het", 2, nh))
        overlaps = [full[:S, :S]] * 2
        W, N = 2, 40
    elif name in ("p3", "p4", "p8", "p8_rare_rec"):
        P = int(name[1])
        # polyploid combos: each selected hap expands to its sample's group
        # of P haps; the last group is cut short by the haplotype count, so
        # its missing places are the reference (0) and it overlaps [0]*P
        nhap = 1 + 3 * P - 1
        combos = increment_vector([0, 1, P + 1, 2 * P + 1], "het", P, nhap - 1)
        overlaps = [et.state_overlap(combos),
                    et.state_overlap(_random_multisets(rng, 9, P, 4)),
                    et.state_overlap(_random_multisets(rng, 6, P, 3))]
    elif name == "s1":
        overlaps = [et.state_overlap([[0, 0]])] * W
    else:
        overlaps = [et.state_overlap(_random_multisets(rng, s, P, 5))
                    for s in (6, 6, 4)]
    if name == "n1":
        N = 1
    logE, kind, dist, ov, log_w, smask = _inputs(rng, W, N, overlaps, P)
    if name == "all_pad":
        kind[1] = 0
        kind[2, 15:] = 0
    elif name == "resets_at_ends":
        kind[:, 0] = 2
        kind[:, -1] = 2
        kind[1, 7:9] = 2
    elif name == "zero_distances":
        dist[0, :, [0, 5, 6, N - 1]] = 0     # forward and backward
        dist[1, 0, :] = 0                    # every forward distance
        dist[2, 1, 3] = 0
    elif name == "far":
        # far enough that exp(-d / n) is 0: rec = norec = 1 / n, every class
        # weighs the same
        dist[:] = 10 ** 14
    elif name not in ("s1", "n1"):
        kind[0, [3, 4, 11]] = 2
        kind[1, 20:] = 0
    if name in OVERLAP_CASES:
        valid = smask[:, :, None] & smask[:, None, :]
        if name == "dense":
            ov[:] = rng.integers(0, P + 1, ov.shape)
        elif name == "all_zero":
            ov[:] = 0
        elif name == "all_P":
            ov[:] = P
        else:
            ov[0, 1, 2] = P + 3                # one entry, one column
            ov[1, :, 0] = P + 1                # a whole column
            ov[2, 3, :] = 255                  # a whole row
        ov[~valid] = 0
    elif S is None and name != "s1":
        assert (ov <= P).all() and len({int(v) for v in ov.ravel()}) > 1
    # p8_rare_rec: the 100 Mb graph's 101 haplotypes make rec ~1e-9, so
    # rec^k of the middle classes lies near float32's smallest values
    nhap = 101 if name == "p8_rare_rec" else 5
    lrf, lnrf = et._transition_logs(dist[:, 0], nhap)
    lrb, lnrb = et._transition_logs(dist[:, 1], nhap)
    return (logE, kind, lrf, lnrf, lrb, lnrb, ov, log_w, smask), P


def _pair_overlap(states, device="cpu"):
    """[S, S] int32 overlap of diploid states (pairs of haplotypes), formed
    on ``device``: the larger matching of two pairs, max([a = c] + [b = d],
    [a = d] + [b = c]), which is state_overlap's multiset intersection for
    P = 2 without its [S, S, haplotypes] intermediate."""
    st = torch.tensor(states, dtype=torch.int32, device=device)
    a, b = st[:, 0], st[:, 1]
    same = (a[:, None] == a[None, :]).int() + (b[:, None] == b[None, :]).int()
    cross = (a[:, None] == b[None, :]).int() + (b[:, None] == a[None, :]).int()
    return torch.maximum(same, cross).to(torch.int32)


def _het_states(S):
    """The first S diploid het states of the fewest haplotypes that give S."""
    h = 1
    while h * (h + 1) // 2 < S:
        h += 1
    return increment_vector(list(range(h)), "het", 2, h - 1)[:S]


@pytest.mark.parametrize("S", [1, 15, 120, 253])
def test_pair_overlap_is_state_overlap(S):
    states = _het_states(S)
    np.testing.assert_array_equal(_pair_overlap(states).numpy(),
                                  et.state_overlap(states))


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _plain(arrays, fre, P, device="cpu"):
    a, b = et._forward_backward_plain(*_torch(arrays, device), fre, P)
    return a.cpu().numpy(), b.cpu().numpy()


@pytest.mark.parametrize("fre", [False, True], ids=["rec", "fre"])
@pytest.mark.parametrize("name", CASES)
def test_plain_forward_backward_matches_jax(name, fre):
    import jax.numpy as jnp

    import varigraph_tpu.genotype.engine_jax as ej

    arrays, P = case_arrays(name, fre)
    want = ej._forward_backward(*(jnp.asarray(a) for a in arrays),
                                jnp.bool_(fre), P)
    got = _plain(arrays, fre, P)
    kind = arrays[1]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        # rows of pad and reset nodes are zero; real rows sum to 1 over the
        # valid states, or are zero in a window without any
        sums = g.sum(axis=2)
        real = kind == 1
        assert not g[~real].any()
        has_states = arrays[8].any(axis=1)[:, None] & real
        np.testing.assert_allclose(sums[has_states], 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["p2", "p4", "all_pad", "n1"])
def test_wrapper_on_cpu_is_scan_exactly(name):
    arrays, P = case_arrays(name, False)
    t = _torch(arrays)
    before = fb_cuda.LAUNCHES["forward_backward"]
    for fre in (False, True):
        alpha, beta = fb_cuda.forward_backward(*t, fre, P)
        logE, kind, lrf, lnrf, lrb, lnrb, ov, log_w, smask = t
        M = (ov[:, None] == torch.arange(P + 1, dtype=ov.dtype)[None, :, None, None]
             ).to(torch.float32)
        nvalid = smask.sum(dim=1, keepdim=True).to(torch.float32)
        uniform = torch.where(smask, 1.0 / nvalid, 0.0)
        e_lw = torch.exp(torch.where(smask, log_w, 0.0))
        for got, lr, lnr, rev in ((alpha, lrf, lnrf, False),
                                  (beta, lrb, lnrb, True)):
            want = et._scan(logE, kind, lr, lnr, M, e_lw, smask, uniform,
                            fre, P, reverse=rev)
            assert torch.equal(got, want)
    assert fb_cuda.LAUNCHES["forward_backward"] == before


BAD = ["logE_dtype", "kind_dtype", "overlap_dtype", "smask_dtype",
       "noncontiguous", "shape", "mixed_devices", "ploidy", "logE_2d"]


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_bad_arguments(bad):
    arrays, P = case_arrays("p2", False)
    t = _torch(arrays)
    if bad == "logE_dtype":
        t[0] = t[0].double()
    elif bad == "kind_dtype":
        t[1] = t[1].long()
    elif bad == "overlap_dtype":
        t[6] = t[6].to(torch.uint8)
    elif bad == "smask_dtype":
        t[8] = t[8].to(torch.uint8)
    elif bad == "noncontiguous":
        t[0] = t[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        t[2] = t[2][:, :-1].contiguous()
    elif bad == "mixed_devices":
        t[7] = torch.empty(t[7].shape, dtype=t[7].dtype, device="meta")
    elif bad == "ploidy":
        P = 256
    elif bad == "logE_2d":
        t[0] = t[0][0]
    with pytest.raises((TypeError, ValueError)):
        fb_cuda.forward_backward(*t, False, P)


def test_engine_routes_through_the_wrapper():
    """genotype_torch's _forward_backward is the wrapper, so the card takes
    the kernel; on the CPU it gives the plain version's rows."""
    assert et._forward_backward is fb_cuda.forward_backward
    arrays, P = case_arrays("p2", False)
    a, b = et._forward_backward(*_torch(arrays), False, P)
    want = _plain(arrays, False, P)
    np.testing.assert_array_equal(a.numpy(), want[0])
    np.testing.assert_array_equal(b.numpy(), want[1])


LAYOUT_CASES = ["p2", "p3", "p4", "p8", "s1", "dense", "all_zero", "all_P",
                "above_P", "S120"]


def _layout_case(name):
    S = 120 if name == "S120" else None
    arrays, P = case_arrays(name, False, S)
    ov = arrays[6]
    lists, goff, full = fb_cuda.fb_layout(torch.from_numpy(ov), P)
    return ov, P, lists.numpy(), goff.numpy(), full.numpy()


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_layout_lists_reproduce_overlap(name):
    """Column j's group c holds exactly the states s with ov[s, j] = c, in
    ascending s, then pads; classes 1..P everywhere, class 0 only in a column
    that holds a class above P, and a class above P nowhere."""
    ov, P, lists, goff, full = _layout_case(name)
    W, S, _ = ov.shape
    slots = lists.transpose(0, 1, 3, 2).reshape(W, -1, S)      # [W, L, S]
    assert lists.dtype == np.int16 and goff.dtype == np.int32
    assert goff.shape == (W, P + 2) and (goff % 2 == 0).all()
    assert (np.diff(goff, axis=1) >= 0).all() and (goff[:, 0] == 0).all()
    assert slots.shape[1] == goff[:, -1].max()
    np.testing.assert_array_equal(full, (ov > P).any(axis=1))
    for w in range(W):
        for c in range(P + 1):
            group = slots[w, goff[w, c]:goff[w, c + 1]]           # [extent, S]
            for j in range(S):
                want = np.nonzero(ov[w, :, j] == c)[0]
                if c == 0 and not full[w, j]:
                    want = want[:0]
                got = group[:, j]
                n = len(want)
                np.testing.assert_array_equal(got[:n], want)
                assert (got[n:] == S).all()
            # padded to the window's longest, rounded up to even
            counts = [(ov[w, :, j] == c).sum() if c or full[w, j] else 0
                      for j in range(S)]
            assert goff[w, c + 1] - goff[w, c] == (max(counts) + 1) // 2 * 2
        # slots past the window's own end are pads
        assert (slots[w, goff[w, -1]:] == S).all()


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_list_flow_matches_dense_flow(name):
    """t[0] * R + sum_c (t[c] - t[0]) * acc_c over the lists (R summed from
    the listed class-0 entries in a column with a class above P) equals the
    dense sum_c t[c] * (row . M_c), at rec > 0, rec = 0 and rec = norec."""
    ov, P, lists, goff, full = _layout_case(name)
    W, S, _ = ov.shape
    rng = np.random.default_rng(LAYOUT_CASES.index(name))
    row = rng.random((W, S)).astype(np.float32)
    row /= row.sum(axis=1, keepdims=True)
    slots = torch.from_numpy(lists).permute(0, 1, 3, 2).reshape(W, -1, S).long()
    for lr, lnr in ((-9.0, -0.01), (-np.inf, -0.0001), (-1.6, -1.6)):
        c = torch.arange(P + 1, dtype=torch.float32)
        a = torch.where(c == 0, 0.0, c * lnr)
        b = torch.where(P - c == 0, 0.0, (P - c) * np.float32(lr))
        t = torch.exp(a + b)
        r = torch.from_numpy(row)
        M = torch.from_numpy(ov)[:, None] == torch.arange(P + 1)[None, :, None, None]
        dense = torch.einsum("ws,wcsj,c->wj", r, M.float(), t)
        src = torch.cat([r, torch.zeros(W, 1)], dim=1)          # pad index S
        got = torch.empty(W, S)
        for w in range(W):
            f = torch.zeros(S)
            listed = torch.zeros(S)
            for cc in range(P + 1):
                k = slots[w, goff[w, cc]:goff[w, cc + 1]]        # [extent, S]
                acc = src[w][k].sum(dim=0)
                listed += acc
                f += (t[cc] - t[0]) * acc
            base = torch.where(torch.from_numpy(full[w]), listed, r[w].sum())
            got[w] = t[0] * base + f
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL, rtol=0)


# ------------------------------------------------------------ on the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forward/backward kernel has no "
                    "CPU mode")


def _kernel(arrays, fre, P):
    a, b = fb_cuda.forward_backward(*_torch(arrays, "cuda"), fre, P)
    torch.cuda.synchronize()
    return a.cpu().numpy(), b.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("fre", [False, True], ids=["rec", "fre"])
@pytest.mark.parametrize("name", CASES + ["S120", "S253", "S465", "S496"])
def test_cuda_kernel_matches_plain(name, fre):
    _need_card()
    S = int(name[1:]) if name.startswith("S") else None
    arrays, P = case_arrays(name, fre, S)
    want = _plain(arrays, fre, P, "cuda")
    before = fb_cuda.LAUNCHES["forward_backward"]
    got = _kernel(arrays, fre, P)
    assert fb_cuda.LAUNCHES["forward_backward"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # run to run, bit for bit
    again = _kernel(arrays, fre, P)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("fre", [False, True], ids=["rec", "fre"])
def test_cuda_kernel_split_invariance(fre):
    """One window alone equals the same window as row 37 of a 64-window
    batch, bit for bit."""
    _need_card()
    arrays, P = case_arrays("S120", fre, 120)
    rng = np.random.default_rng(5)
    batch = [np.repeat(a[:1], 64, axis=0).copy() for a in arrays]
    batch[0] = rng.normal(-40.0, 6.0, batch[0].shape).astype(np.float32)
    for b, a in zip(batch, arrays):
        b[37] = a[0]
    alone = _kernel([a[:1] for a in arrays], fre, P)
    inside = _kernel(batch, fre, P)
    for x, y in zip(alone, inside):
        np.testing.assert_array_equal(x[0], y[37])


LARGE = ["S780", "S780_dense", "S1275", "S2080", "S3081", "max"]


def _large_case(name, device):
    """(logE, kind, lrf, lnrf, lrb, lnrb, overlap, log_w, smask) on
    ``device``, P = 2: two windows of the first S diploid het states (window
    1 with its last third padded and two pad nodes at its end, window 0 with
    a reset), 101 haplotypes' distances; "max" at the most states a launch
    takes (12 nodes), "_dense" with a random class 0..2 in every entry."""
    P, W = 2, 2
    S = (int(fb_cuda.build().vg_fb_max_states()) if name == "max"
         else int(name.split("_")[0][1:]))
    N = 12 if S > 3000 else 40
    rng = np.random.default_rng(S)
    gen = torch.Generator(device=device).manual_seed(S)
    ov = _pair_overlap(_het_states(S), device).expand(W, S, S).contiguous()
    if name.endswith("_dense"):
        ov = torch.randint(0, P + 1, (W, S, S), generator=gen, device=device,
                           dtype=torch.int32)
    smask = torch.ones((W, S), dtype=torch.bool, device=device)
    smask[1, S - S // 3:] = False
    ov[1, ~smask[1]] = 0
    ov[1, :, ~smask[1]] = 0
    logE = torch.randn((W, N, S), generator=gen, device=device) * 6.0 - 40.0
    logE = torch.where(smask[:, None, :], logE, -math.inf).contiguous()
    kind = np.ones((W, N), np.int32)
    kind[0, N // 3] = 2
    kind[1, -2:] = 0
    dist = rng.integers(0, 200_000, (W, 2, N))
    lrf, lnrf = et._transition_logs(dist[:, 0], 101)
    lrb, lnrb = et._transition_logs(dist[:, 1], 101)
    w = rng.random((W, S))
    log_w = np.where(smask.cpu().numpy(), np.log(w / w.sum(axis=1, keepdims=True)),
                     0.0).astype(np.float32)
    host = [kind, lrf, lnrf, lrb, lnrb]
    return [logE, *(torch.from_numpy(a).to(device) for a in host), ov,
            torch.from_numpy(log_w).to(device), smask], P


@pytest.mark.cuda
@pytest.mark.parametrize("fre", [False, True], ids=["rec", "fre"])
@pytest.mark.parametrize("name", LARGE)
def test_cuda_kernel_large_states(name, fre):
    """Above S = 512 (the lists in shared or device memory) and above 1,024
    (the wide kernel, any number of states a thread) up to the most states a
    launch takes, against plain, and bit-identical run to run."""
    _need_card()
    t, P = _large_case(name, "cuda")
    want = et._forward_backward_plain(*t, fre, P)
    got = fb_cuda.forward_backward(*t, fre, P)
    again = fb_cuda.forward_backward(*t, fre, P)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        assert float((g - w).abs().max()) <= ATOL
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [120, 465])
def test_cuda_kernel_split_invariance_beside_dense_window(S):
    """A window alone (its lists in registers) equals the same window in a
    batch whose other window has a dense overlap (more than 32 list words a
    column, so the batch takes the list path), bit for bit."""
    _need_card()
    arrays, P = case_arrays(f"S{S}", False, S)
    batch = [a.copy() for a in arrays]
    batch[6][1] = np.random.default_rng(S).integers(0, P + 1, (S, S))
    alone = _kernel([a[:1] for a in arrays], False, P)
    inside = _kernel(batch, False, P)
    for x, y, w in zip(alone, inside, _plain(batch, False, P, "cuda")):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_allclose(y, w, atol=ATOL, rtol=0)
