"""The genotyping emissions: log-emission of every (node, state).

The port's plain version with the kernel's contract
(varigraph_tpu_torch/ops/emit.py ``emissions_plain``: the state-count matrix
built from the states' used-hap slots, then ``engine_torch._emissions_body``)
must equal the JAX package's ``_emissions_group`` (varigraph_tpu/genotype/
engine_jax.py) on the cases below: ploidy 2, 3, 4 and 8 (random multisets,
so homozygous slots too), two hap words (40 used haps), one state, only
homozygous states, masked states whose slot rows hold garbage, pad node rows,
coverage at exactly lower, upper, ave * h, 0 and 255, frequencies 0, 1, 2 and
5 with and without the ref flag, no valid k-mer at all, a node where the
verification decrement fires, and ave 4 and 23.  A pure-torch emulation of
the kernel csrc/emit.cu (the words htmp, need and eff = htmp & ~dec; the
launch-wide term table over (c, h) with one term computed a valid k-mer of
a row; a lane's states in passes, each slot's bit a mask test, h selecting
the term; four partial sums over k = j mod 4) must equal the plain version
on the same cases, and the first kernel's design (a term table over h = 0..P
built for each row) bit for bit: the check of the kernel's design that runs
without a card.  Every term the table gives equals the term computed for its
k-mer alone, bit for bit, at every c, f in {0, 1, 2, 5, 255} with and
without the ref flag, h and P.  The wrapper (ops/emit_cuda.emissions_) runs
the plain version on CPU tensors; on the card the kernel is held against
plain on every case, at S = 120, 465 and 3,081 (3 words), at K = 37, on
tensors off a 16-byte boundary and at five words with P = 5; bit for bit
run to run and across batch positions, one launch a call; a bad slot is an
error on the card (a device assert, in a process of its own) as on the CPU.

Tolerance: rtol 4e-6 (about 32 float32 ulp) on finite log-emissions, -inf and
NaN at exactly the same places (f = 0 makes floor(c / 0) inf or NaN, as in
the JAX body).  The tolerance and its reason are tests/test_torch_engine.py's:
each value is a float32 sum of up to 128 terms taken in another order, and
lgamma comes from another library.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import (  # noqa: E402
    get_error_param, poisson_interval)
from varigraph_tpu_torch.ops import emit_cuda  # noqa: E402
from varigraph_tpu_torch.ops.emit import emissions_plain, state_counts  # noqa: E402

# The JAX side is imported inside the tests that use it: the machine with the
# card has no JAX, and runs the kernel cases of this file alone with
#   python -m pytest --noconftest -m cuda tests/test_torch_emit.py

RTOL = 4e-6
K = 128
CASES = ["p2", "p3", "p4", "p8", "w2", "s1", "hom", "masked", "pad_rows",
         "bounds", "f_flag", "no_kmask", "verify", "ave4", "ave23"]
# het pairs of n haplotypes: S = n (n - 1) / 2
LARGE = {"S120": 16, "S465": 31, "S3081": 79}


def _scalars(ave, lower=None, upper=None):
    """(ave, lower, upper, log_p, log_q, log_prior) as genotype_torch makes
    them, float32 values; lower and upper may be given."""
    if lower is None:
        lower, upper = poisson_interval(ave)
    p = get_error_param(ave)
    log_prior = (np.log(1.0 / np.sqrt(2 * np.pi * 0.05))
                 - (p - 0.5) ** 2 / (2 * 0.05))
    return tuple(float(np.float32(x)) for x in
                 (ave, lower, upper, np.log(p), np.log(1.0 - p), log_prior))


def _words(rng, shape, n_used, density=0.5):
    """Random hap words [..., W]: bit u set with the given density for the
    n_used used haps, 0 beyond."""
    W = shape[-1]
    b = rng.random(shape[:-1] + (32 * W,)) < density
    b[..., n_used:] = False
    w = (b.reshape(shape[:-1] + (W, 32)).astype(np.uint64)
         << np.arange(32, dtype=np.uint64)).sum(axis=-1)
    return w.astype(np.uint32)


def case_arrays(name):
    """(arrays, scalars): c, f uint8 [G, N, K]; flag, kmask bool; bits, local
    uint32 [G, N, K, W]; gt0 bool [G, N, 32 W]; state_u int32 [G, S, P];
    smask bool [G, S] (window 1's last quarter of states masked)."""
    large = name in LARGE
    rng = np.random.default_rng(LARGE[name] if large else CASES.index(name))
    P = {"p3": 3, "p4": 4, "p8": 8}.get(name, 2)
    n_used = LARGE.get(name, 40 if name == "w2" else 12)
    W = -(-n_used // 32)
    G, N = 2, 5
    if large:
        states = np.array([(i, j) for i in range(n_used)
                           for j in range(i + 1, n_used)], np.int32)
        S = len(states)
    else:
        S = {"s1": 1, "masked": 16}.get(name, 12)
        states = np.sort(rng.integers(0, n_used, (S, P)), axis=1).astype(np.int32)
    ave = {"ave4": 4.0, "ave23": 23.0, "bounds": 10.0}.get(name, 9.5)
    scal = (_scalars(ave, 6.0, 14.0) if name == "bounds" else _scalars(ave))
    lower = scal[1]

    c = rng.integers(0, 3 * int(ave) + 5, (G, N, K)).astype(np.uint8)
    f = rng.integers(1, 5, (G, N, K)).astype(np.uint8)
    flag = rng.random((G, N, K)) < 0.3
    kmask = rng.random((G, N, K)) < 0.8
    bits = _words(rng, (G, N, K, W), n_used)
    local = _words(rng, (G, N, K, W), n_used)
    gt0 = rng.random((G, N, 32 * W)) < 0.5
    gt0[..., n_used:] = False
    state_u = np.repeat(states[None], G, axis=0)
    smask = np.ones((G, S), bool)
    if S >= 4:
        smask[1, S - S // 4:] = False
        state_u[1, S - S // 4:] = 0

    if name == "hom":
        state_u[..., 1] = state_u[..., 0]
    elif name == "masked":
        smask[:, ::2] = False
        state_u[~smask] = 1000                # never read
    elif name == "pad_rows":
        for a in (c, f, flag, kmask, bits, local, gt0):
            a[0, 3:] = 0                      # the engine's pad rows
        kmask[1, 0] = False                   # a row of no valid k-mer
    elif name == "bounds":
        c[:] = rng.choice([0, 5, 6, 7, 10, 13, 14, 15, 20, 30, 255], (G, N, K))
        f[:] = rng.choice([1, 2, 5], (G, N, K))
        f[0, 1, :20] = 0
        flag[:] = rng.random((G, N, K)) < 0.5
        kmask[:] = True
    elif name == "f_flag":
        f[:] = rng.choice([1, 2, 5], (G, N, K))
        f[1, 2, ::9] = 0
        flag[:] = rng.random((G, N, K)) < 0.5
    elif name == "no_kmask":
        kmask[:] = False
    elif name == "verify":
        # c below lower with f >= 2 (the trigger and the decrement), local
        # bits sparse, so dec = htmp & need & ~local is mostly htmp
        c[:] = rng.integers(0, int(lower) + 1, (G, N, K))
        c[:, :, ::3] += np.uint8(int(lower) + 1)
        f[:] = rng.integers(2, 6, (G, N, K))
        local[:] = _words(rng, (G, N, K, W), n_used, 0.1)
        kmask[:] = True
    return [c, f, flag, kmask, bits, local, gt0, state_u, smask], scal


def _torch(arrays, device="cpu"):
    c, f, flag, kmask, bits, local, gt0, state_u, smask = arrays
    host = [c, f, flag, kmask, bits.view(np.int32), local.view(np.int32), gt0,
            state_u, smask]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host]


def _out(arrays, device="cpu"):
    c, S = arrays[0], arrays[8].shape[1]
    return torch.empty(c.shape[:2] + (S,), dtype=torch.float32, device=device)


def _plain(arrays, scal, device="cpu"):
    out = _out(arrays, device)
    emissions_plain(out, *_torch(arrays, device), *scal)
    return out.cpu().numpy()


def _assert_close(got, want):
    """-inf and NaN at the same places; finite values within RTOL."""
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=0)


def _state_cnt_np(state_u, smask, U):
    G, S, P = state_u.shape
    cnt = np.zeros((G, U, S), np.float32)
    for g in range(G):
        for s in range(S):
            if smask[g, s]:
                for u in state_u[g, s]:
                    cnt[g, u, s] += 1.0
    return cnt


@pytest.mark.parametrize("name", CASES)
def test_plain_emissions_match_jax(name):
    """Each side is called twice on the case's inputs.  The port's first
    and second calls must be bit-identical, and both are held against
    JAX's second call.  JAX's first call of a shape is its compile, the one
    value not held: its largest difference from the second goes into any
    failure message, beside the port's, so a drift names its side."""
    import jax.numpy as jnp

    import varigraph_tpu.genotype.engine_jax as ej

    arrays, scal = case_arrays(name)
    c, f, flag, kmask, bits, local, gt0, state_u, smask = arrays
    cnt = _state_cnt_np(state_u, smask, gt0.shape[-1])
    args = [jnp.asarray(a) for a in (c.astype(np.int32), f.astype(np.int32),
                                     flag, kmask, bits, local, gt0, cnt, smask)]
    want_cold = np.asarray(ej._emissions_group(*args, *scal))
    want = np.asarray(ej._emissions_group(*args, *scal))
    got_cold = _plain(arrays, scal)
    got = _plain(arrays, scal)
    fin = np.isfinite(want)
    drift = (f"first call vs second, max abs difference: JAX "
             f"{np.abs(want_cold[fin] - want[fin]).max()}, torch "
             f"{np.abs(got_cold[fin] - got[fin]).max()}")
    np.testing.assert_array_equal(
        got_cold, got, err_msg=f"the port's first call differs from its second; {drift}")
    for call, value in (("first", got_cold), ("second", got)):
        try:
            _assert_close(value, want)
        except AssertionError as e:
            raise AssertionError(f"the port's {call} call: {e}\n{drift}") from None
    assert np.isfinite(got).any() or name == "masked"
    if name == "no_kmask":      # no valid k-mer: 0 for every valid state
        assert (got[np.broadcast_to(smask[:, None], got.shape)] == 0).all()


def test_state_counts_match_numpy():
    arrays, _ = case_arrays("p8")
    state_u, smask = arrays[7], arrays[8]
    got = state_counts(torch.from_numpy(state_u), torch.from_numpy(smask), 32)
    np.testing.assert_array_equal(got.numpy(), _state_cnt_np(state_u, smask, 32))


# ------------------------------------------------- the kernel's design on CPU

def _emulate_row_table(arrays, scal):
    """logE [G, N, S] computed the way of the first kernel (a term table over
    h = 0..P built for each node row), in torch on the CPU."""
    c, f, flag, kmask, bits, local, gt0, state_u, smask = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    G, N, _ = c.shape
    W, S, P = bits.shape[-1], smask.shape[1], state_u.shape[-1]
    ave, lower, upper, log_p, log_q, log_prior = (
        torch.tensor(x, dtype=torch.float32) for x in scal)
    cf, fi = c.to(torch.float32), f.to(torch.int64)
    eff, dec = _eff_words(c, f, flag, kmask, bits, local, gt0, scal)
    # the term table over h = 0..P
    hv = torch.arange(P + 1, dtype=torch.float32)
    meanv = ave * hv
    logmean = torch.log(torch.clamp(meanv, min=1e-30))
    fe = torch.where(flag & (fi == 1), 2, fi)[..., None]
    ff = fe.to(torch.float32)
    cB = cf[..., None]
    cc0 = torch.where((cB > ave) & (ff > cB / upper), 0.0, torch.floor(cB / ff))
    cch = torch.where(cB > meanv, torch.floor(meanv), cB)
    cc = torch.where(fe == 1, cB, torch.where(hv == 0, cc0, cch))
    log_geo = (log_prior + cc * log_q) + (1.0 - cc) * log_p
    log_poi = (-meanv + cc * logmean) - torch.lgamma(cc + 1.0)
    term = torch.where(hv == 0, log_geo, log_poi)
    term = torch.where(kmask[..., None], term, 0.0)          # [G, N, K, P + 1]
    # a bit test a slot, a table read a k-mer, four partial sums over k mod 4
    su = torch.where(smask[..., None], state_u.to(torch.int64), 0)   # [G, S, P]
    wsel = (su >> 5)[:, None, None].expand(G, N, K, S, P)
    word = torch.gather(eff[:, :, :, None, :].expand(G, N, K, S, W), 4, wsel)
    h = ((word >> (su & 31)[:, None, None]) & 1).sum(dim=-1)  # [G, N, K, S]
    t = torch.gather(term, 3, h)
    part = [torch.zeros((G, N, S), dtype=torch.float32) for _ in range(4)]
    for k in range(K):
        part[k % 4] = part[k % 4] + t[:, :, k]
    acc = (part[0] + part[1]) + (part[2] + part[3])
    return torch.where(smask[:, None, :], acc, -math.inf).numpy(), (dec != 0)


def _eff_words(c, f, flag, kmask, bits, local, gt0, scal):
    """(eff, dec) int64 [G, N, K, W]: the words htmp, need, and
    eff = htmp & ~dec of every k-mer."""
    G, N, _ = c.shape
    W = bits.shape[-1]
    lower, upper = (torch.tensor(x, dtype=torch.float32) for x in scal[1:3])
    cf, fi = c.to(torch.float32), f.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64)
    gt0w = (gt0.view(G, N, W, 32).to(torch.int64) << shifts).sum(dim=-1)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    ci = flag & (cf >= lower) & (cf <= upper)
    htmp = words | torch.where(ci[..., None], gt0w[:, :, None, :], 0)
    trigger = (cf < lower) & (fi >= 2) & kmask
    need = torch.zeros((G, N, W), dtype=torch.int64)
    for k in range(c.shape[2]):
        need |= torch.where(trigger[:, :, k, None], htmp[:, :, k], 0)
    verify = (cf <= lower) & (fi >= 2)
    dec = torch.where(verify[..., None],
                      htmp & need[:, :, None, :] & ~(local.to(torch.int64) & 0xFFFFFFFF), 0)
    return htmp & ~dec, dec


# lgamma(i + 1), i = 0..255: cc is such an integer unless f = 0 makes it
# inf or NaN, so one evaluation a value gives every term the same bits
_LGAMMA1 = torch.lgamma(torch.arange(256, dtype=torch.float32) + 1.0)


def _lgamma1(cc):
    inside = (cc >= 0) & (cc < 256)
    idx = torch.where(inside, cc, 0.0).to(torch.int64)
    return torch.where(inside, _LGAMMA1[idx], torch.lgamma(cc + 1.0))


def _terms(cB, fe, h, scal, P):
    """term(c, fe, h) by the plain version's float32 operations (cap,
    c_div_f, zero_out, cc, log_geo, log_poi) on broadcast tensors: cB
    float32, fe and h int64; the mean and its log come from a table over
    h = 0..P, as the kernel's table builder forms them."""
    ave, lower, upper, log_p, log_q, log_prior = (
        torch.tensor(x, dtype=torch.float32) for x in scal)
    meanv_h = ave * torch.arange(P + 1, dtype=torch.float32)
    logmean_h = torch.log(torch.clamp(meanv_h, min=1e-30))
    meanv, logmean = meanv_h[h], logmean_h[h]
    ff = fe.to(torch.float32)
    cc0 = torch.where((cB > ave) & (ff > cB / upper), 0.0, torch.floor(cB / ff))
    cch = torch.where(cB > meanv, torch.floor(meanv), cB)
    cc = torch.where(fe == 1, cB, torch.where(h == 0, cc0, cch))
    log_geo = (log_prior + cc * log_q) + (1.0 - cc) * log_p
    log_poi = (-meanv + cc * logmean) - _lgamma1(cc)
    return torch.where(h == 0, log_geo, log_poi)


def _term_table(P, scal):
    """The kernel's launch-wide table [256, 2P + 1]: for each c the terms at
    fe == 1 over h = 0..P, then at fe != 1 over h = 1..P."""
    c = torch.arange(256, dtype=torch.float32)[:, None]
    one = _terms(c, torch.ones(1, dtype=torch.int64),
                 torch.arange(P + 1)[None], scal, P)
    cap = _terms(c, torch.full((1,), 2, dtype=torch.int64),
                 torch.arange(1, P + 1)[None], scal, P)
    return torch.cat([one, cap], dim=1)


def _record_terms(tab, c, fe, scal, P):
    """A valid k-mer's P + 1 terms [..., P + 1] as a row of the kernel forms
    them: h = 0 at fe != 1 computed (one division), the rest read from the
    launch-wide table."""
    one = fe == 1
    ci = c.to(torch.int64)
    cols = torch.where(one[..., None], 0, P) + torch.arange(1, P + 1)
    rest = tab[ci[..., None], cols]
    t0 = torch.where(one, tab[ci, 0],
                     _terms(c.to(torch.float32), fe, torch.zeros_like(fe), scal, P))
    return torch.cat([t0[..., None], rest], dim=-1)


def _lane_states(P):
    """States a lane of the kernel holds in registers in one pass."""
    return 4 if P <= 4 else 2


def _pick(t, b, P):
    """t[..., sum_p b[..., p]] as the kernel takes it: at P <= 2 a select
    tree (level p picks between neighbours by bit p), above it the count h
    indexing the record."""
    if P <= 2:
        v = [t[..., i] for i in range(P + 1)]
        for p in range(P - 1, -1, -1):
            v = [torch.where(b[..., p], v[i + 1], v[i]) for i in range(p + 1)]
        return v[0]
    h = b.to(torch.int64).sum(dim=-1, keepdim=True)
    return torch.gather(t, -1, h)[..., 0]


def _emulate(arrays, scal):
    """logE [G, N, S] computed the kernel's way, in torch on the CPU: the
    launch-wide term table, one computed term a valid k-mer of a row, and a
    lane's states in passes of 32 x _lane_states(P) states, each slot's bit
    a mask test, the term picked by h, four partial sums over k = j (mod 4)
    up to the row's last valid k-mer, joined as (a0 + a1) + (a2 + a3)."""
    c, f, flag, kmask, bits, local, gt0, state_u, smask = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    G, N, Kr = c.shape
    W, S, P = bits.shape[-1], smask.shape[1], state_u.shape[-1]
    fi = f.to(torch.int64)
    eff, dec = _eff_words(c, f, flag, kmask, bits, local, gt0, scal)
    fe = torch.where(flag & (fi == 1), 2, fi)
    terms = _record_terms(_term_table(P, scal), c, fe, scal, P)
    terms = torch.where(kmask[..., None], terms, 0.0)       # [G, N, K, P + 1]
    ks = torch.arange(Kr)
    kn = torch.where(kmask, ks + 1, 0).amax(dim=-1)           # [G, N]
    su = torch.where(smask[..., None], state_u.to(torch.int64), 0)   # [G, S, P]
    m = torch.ones((), dtype=torch.int64) << (su & 31)
    off = su >> 5
    out = []
    for s0 in range(0, S, 32 * _lane_states(P)):
        sl = slice(s0, s0 + 32 * _lane_states(P))
        ms, offs = m[:, sl], off[:, sl]                     # [G, Sp, P]
        Sp = ms.shape[1]
        word = torch.gather(eff[:, :, :, None, :].expand(G, N, Kr, Sp, W), 4,
                            offs[:, None, None].expand(G, N, Kr, Sp, P))
        b = (word & ms[:, None, None]) != 0                 # [G, N, K, Sp, P]
        t = _pick(terms[:, :, :, None, :].expand(G, N, Kr, Sp, P + 1), b, P)
        part = [torch.zeros((G, N, Sp), dtype=torch.float32) for _ in range(4)]
        for k in range(Kr):
            live = (k < kn)[..., None]
            part[k % 4] = torch.where(live, part[k % 4] + t[:, :, k], part[k % 4])
        out.append((part[0] + part[1]) + (part[2] + part[3]))
    acc = torch.cat(out, dim=-1)
    return torch.where(smask[:, None, :], acc, -math.inf).numpy(), (dec != 0)


@pytest.mark.parametrize("name", CASES)
def test_kernel_emulation_matches_plain(name):
    """The design's emulation against plain, and bit for bit against the
    first kernel's emulation (the per-state order kept)."""
    arrays, scal = case_arrays(name)
    got, dec = _emulate(arrays, scal)
    _assert_close(got, _plain(arrays, scal))
    first, _ = _emulate_row_table(arrays, scal)
    np.testing.assert_array_equal(got.view(np.int32), first.view(np.int32))
    if name == "verify":        # the decrement fired
        assert dec.any()


@pytest.mark.parametrize("ave", [4.0, 10.3, 23.0])
@pytest.mark.parametrize("P", range(1, 9))
def test_term_table_lookup_is_the_per_kmer_term(P, ave):
    """Every c in 0..255, f in {0, 1, 2, 5, 255} with and without the ref
    flag, h in 0..P: the term a row takes from the launch-wide table (and
    its one computed term) has the float32 bits of the term computed for
    the k-mer alone."""
    scal = _scalars(ave)
    c, f, flag = (torch.from_numpy(x.reshape(-1)) for x in np.meshgrid(
        np.arange(256, dtype=np.uint8), np.array([0, 1, 2, 5, 255], np.uint8),
        np.array([False, True]), indexing="ij"))
    fi = f.to(torch.int64)
    fe = torch.where(flag & (fi == 1), 2, fi)
    alone = _terms(c.to(torch.float32)[:, None], fe[:, None],
                   torch.arange(P + 1)[None], scal, P)
    looked_up = _record_terms(_term_table(P, scal), c, fe, scal, P)
    np.testing.assert_array_equal(looked_up.numpy().view(np.int32),
                                  alone.numpy().view(np.int32))
    assert np.isnan(alone.numpy()).any() and np.isfinite(alone.numpy()).any()


# ------------------------------------------------------------- the wrapper

@pytest.mark.parametrize("name", ["p2", "w2", "masked", "bounds"])
def test_wrapper_on_cpu_is_plain_exactly(name):
    arrays, scal = case_arrays(name)
    out = _out(arrays)
    before = emit_cuda.LAUNCHES["emissions"]
    emit_cuda.emissions_(out, *_torch(arrays), *scal)
    assert emit_cuda.LAUNCHES["emissions"] == before
    np.testing.assert_array_equal(out.numpy(), _plain(arrays, scal))


BAD = ["c_dtype", "bits_dtype", "smask_dtype", "noncontiguous", "shape",
       "mixed_devices", "ploidy", "slot_high", "slot_negative", "out_2d"]


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_bad_arguments(bad):
    arrays, scal = case_arrays("p2")
    t = _torch(arrays)
    out = _out(arrays)
    if bad == "c_dtype":
        t[0] = t[0].to(torch.int32)
    elif bad == "bits_dtype":
        t[4] = t[4].to(torch.int64)
    elif bad == "smask_dtype":
        t[8] = t[8].to(torch.uint8)
    elif bad == "noncontiguous":
        t[1] = t[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        t[6] = t[6][:, :, :16].contiguous()
    elif bad == "mixed_devices":
        t[5] = torch.empty(t[5].shape, dtype=t[5].dtype, device="meta")
    elif bad == "ploidy":
        t[7] = torch.zeros(t[7].shape[:2] + (9,), dtype=torch.int32)
    elif bad == "slot_high":
        t[7][0, 0, 1] = 32
    elif bad == "slot_negative":
        t[7][0, 0, 0] = -1
    elif bad == "out_2d":
        out = out[0]
    with pytest.raises((TypeError, ValueError)):
        emit_cuda.emissions_(out, *t, *scal)


def test_engine_routes_through_the_wrapper():
    """genotype_torch's emissions are the wrapper, so the card takes the
    kernel; its plain version is the engine's own torch body."""
    assert et.emissions_ is emit_cuda.emissions_


# ------------------------------------------------------------ on the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the emissions kernel has no CPU mode")


def _kernel(arrays, scal):
    out = _out(arrays, "cuda")
    emit_cuda.emissions_(out, *_torch(arrays, "cuda"), *scal)
    torch.cuda.synchronize()
    return out.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + list(LARGE))
def test_cuda_kernel_matches_plain(name):
    _need_card()
    arrays, scal = case_arrays(name)
    want = _plain(arrays, scal, "cuda")
    before = emit_cuda.LAUNCHES["emissions"]
    got = _kernel(arrays, scal)
    assert emit_cuda.LAUNCHES["emissions"] == before + 1
    _assert_close(got, want)
    # run to run, bit for bit
    np.testing.assert_array_equal(_kernel(arrays, scal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p4", "w2", "S465"])
def test_cuda_kernel_split_invariance(name):
    """A window alone equals the same window as row 5 of an 8-window batch
    of other windows, bit for bit."""
    _need_card()
    arrays, scal = case_arrays(name)
    rng = np.random.default_rng(5)
    batch = [np.repeat(a[1:], 8, axis=0).copy() for a in arrays]
    batch[0] = rng.integers(0, 40, batch[0].shape).astype(np.uint8)
    for b, a in zip(batch, arrays):
        b[5] = a[0]
    alone = _kernel([a[:1] for a in arrays], scal)
    inside = _kernel(batch, scal)
    np.testing.assert_array_equal(alone[0], inside[5])


# inputs the engine does not make but the kernel takes: rows of K < 128
# k-mers (byte loads), tensors whose storage does not start at a 16-byte
# boundary (no word or 16-byte loads), and five hap words at P = 5 (records
# and slot words read from shared memory, h counted then chained)
ODD = ["k37", "offset", "p5w5"]


def _odd_case(name, device):
    """(tensors after out, scalars) of an ODD case on ``device``."""
    if name == "p5w5":
        rng = np.random.default_rng(55)
        G, N, S, P, n_used = 2, 7, 40, 5, 150
        W = -(-n_used // 32)
        arrays = [rng.integers(0, 30, (G, N, K)).astype(np.uint8),
                  rng.integers(0, 5, (G, N, K)).astype(np.uint8),
                  rng.random((G, N, K)) < 0.3, rng.random((G, N, K)) < 0.8,
                  _words(rng, (G, N, K, W), n_used),
                  _words(rng, (G, N, K, W), n_used, 0.2),
                  rng.random((G, N, 32 * W)) < 0.5,
                  np.sort(rng.integers(0, n_used, (G, S, P)), axis=-1).astype(np.int32),
                  rng.random((G, S)) < 0.9]
        return _torch(arrays, device), _scalars(9.5)
    arrays, scal = case_arrays("p3" if name == "k37" else "p2")
    if name == "k37":
        arrays = [a[:, :, :37].copy() if i < 6 else a for i, a in enumerate(arrays)]
        return _torch(arrays, device), scal
    t = _torch(arrays, device)
    for i in (0, 2, 4):      # c and flag one byte off, bits one word off
        buf = torch.empty(t[i].numel() + 1, dtype=t[i].dtype, device=device)
        buf[1:] = t[i].reshape(-1)
        t[i] = buf[1:].view(t[i].shape)
        assert t[i].is_contiguous()
    return t, scal


@pytest.mark.cuda
@pytest.mark.parametrize("name", ODD)
def test_cuda_kernel_odd_inputs_match_plain(name):
    _need_card()
    t, scal = _odd_case(name, "cuda")
    shape = tuple(t[0].shape[:2]) + (t[8].shape[1],)
    want = torch.empty(shape, dtype=torch.float32, device="cuda")
    emissions_plain(want, *t, *scal)
    got = torch.empty_like(want)
    emit_cuda.emissions_(got, *t, *scal)
    torch.cuda.synchronize()
    _assert_close(got.cpu().numpy(), want.cpu().numpy())


_BAD_SLOT = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, sys.argv[1])
    import test_torch_emit as t
    arrays, scal = t.case_arrays("p2")
    arrays[7][0, 0, 1] = int(sys.argv[2])
    out = t._out(arrays, "cuda")
    try:
        t.emit_cuda.emissions_(out, *t._torch(arrays, "cuda"), *scal)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("raised:", e)
        sys.exit(0)
    print("no error")
    sys.exit(1)
""")


@pytest.mark.cuda
@pytest.mark.parametrize("slot", [32, -1])
def test_cuda_bad_slot_is_an_error(slot):
    """A valid state's slot outside 0..32 W - 1 fails the kernel's device
    assert, which the next synchronize raises.  It leaves the CUDA context
    unusable, so it runs in a process of its own."""
    _need_card()
    r = subprocess.run([sys.executable, "-c", _BAD_SLOT, os.path.dirname(__file__),
                        str(slot)], capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "raised:" in r.stdout and "assert" in r.stdout, r.stdout


@pytest.mark.cuda
def test_cuda_engine_window_chunks_do_not_change_calls(monkeypatch):
    """The card path launched a window at a time (the group's inputs above
    _EMIT_UPLOAD_BYTES) gives the one-launch group's calls exactly."""
    _need_card()
    from varigraph_tpu_torch.config import VarigraphConfig
    from varigraph_tpu_torch.genotype.engine_np import graph2node
    from varigraph_tpu_torch.index.serialize import load_graph

    gi = load_graph(os.path.join(os.path.dirname(__file__), "fixtures",
                                 "slice2m", "graph.vgt"), device="cuda")
    graph2node(gi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    gi.table.cov.copy_(torch.randint(0, 40, gi.table.cov.shape, generator=gen,
                                     device="cuda", dtype=gi.table.cov.dtype))
    cfg = VarigraphConfig(device="cuda")
    before = emit_cuda.LAUNCHES["emissions"]
    base = et.genotype_torch(gi, cfg, 10.0, 0, device="cuda")
    one = emit_cuda.LAUNCHES["emissions"] - before
    monkeypatch.setattr(et, "_EMIT_UPLOAD_BYTES", 1)
    got = et.genotype_torch(gi, cfg, 10.0, 0, device="cuda")
    assert emit_cuda.LAUNCHES["emissions"] - before - one > one
    assert set(got) == set(base) and base
    for k in base:
        assert got[k].hap_vec == base[k].hap_vec, k
        assert got[k].probability == base[k].probability, k
