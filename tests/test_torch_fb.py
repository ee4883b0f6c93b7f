"""The forward/backward scan: alpha and beta of every window's HMM.

The port's plain version (varigraph_tpu_torch/genotype/engine_torch.py
``_forward_backward_plain``, ``_scan`` over the overlap-class masks) must
equal the JAX package's ``_forward_backward`` (varigraph_tpu/genotype/
engine_jax.py) at atol 1e-6 on the edge cases below: ploidy 2, 3, 4 and 8
(overlaps from ``increment_vector``'s polyploid combos and from random
multisets), one state, one node, a window of pad nodes only, resets at the
first and last node, zero distances in both directions; rec and fre.  The
wrapper (ops/fb_cuda.forward_backward) runs the plain version on CPU
tensors, and on the card the CUDA kernel (csrc/fb.cu), which is held against
the plain version on the same cases and at S = 120, 253 and 496.

Tolerance: atol 1e-6 (about 8 ulp at 1.0) on the normalized alpha/beta,
values in [0, 1]: float32 sums taken in another order (per overlap class
and then over classes in the plain version, per state in the kernel, XLA's
own order in JAX); per-step normalization keeps the errors from growing.
"""

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
         "zero_distances"]


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
    elif name in ("p3", "p4", "p8"):
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
    elif name not in ("s1", "n1"):
        kind[0, [3, 4, 11]] = 2
        kind[1, 20:] = 0
    if S is None and name != "s1":
        assert (ov <= P).all() and len({int(v) for v in ov.ravel()}) > 1
    lrf, lnrf = et._transition_logs(dist[:, 0], 5)
    lrb, lnrb = et._transition_logs(dist[:, 1], 5)
    return (logE, kind, lrf, lnrf, lrb, lnrb, ov, log_w, smask), P


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
@pytest.mark.parametrize("name", CASES + ["S120", "S253", "S496"])
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
