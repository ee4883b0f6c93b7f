"""The counting Bloom filter and the exact genome counter of the torch port
(varigraph_tpu_torch/ops/{murmur3,cbf,cbf_cuda,exact_count}.py) against the
JAX package's (varigraph_tpu/ops/{murmur3,cbf,exact_count}.py).

Integer state must be bit-exact: hashes, sizing, seeds, filter bytes after
every add (masked adds and saturation at 255 included), counts, and exact
genome counts.  The CUDA kernel (csrc/cbf.cu) is held against the plain torch
version on the card by the ``cuda``-marked cases."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from varigraph_tpu_torch.ops import cbf_cuda  # noqa: E402
from varigraph_tpu_torch.ops.cbf import (  # noqa: E402
    CountingBloomFilter, cbf_add_plain, cbf_count_plain, cbf_num_hashes,
    cbf_size, make_seeds)
from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter  # noqa: E402
from varigraph_tpu_torch.ops.murmur3 import murmur3_x64_128_u64key  # noqa: E402
from varigraph_tpu_torch.ops.table import count_join  # noqa: E402

# The JAX side is imported inside the tests that use it: the machine with the
# card has no JAX, and runs the kernel cases of this file alone with
#   python -m pytest --noconftest -m cuda tests/test_torch_cbf.py

N_FILTER = 2000   # filter sized for 2,000 keys: m = 2^15, kh = 11


def _t(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy -> int64 torch (bit patterns)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64).copy())


def _encodings(rng, n, span=27):
    return (rng.integers(0, 1 << 50, size=n, dtype=np.uint64)
            << np.uint64(8)) | np.uint64(span)


CASES = ["random", "bit63_keys", "masked", "all_masked", "n0",
         "saturate_300", "heavy_duplicates"]


def _case(name):
    """A list of (keys uint64, mask bool) adds, then the query keys."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    keys = _encodings(rng, 1500)
    ones = np.ones(len(keys), bool)
    if name == "random":
        adds = [(keys, ones), (keys[:300], ones[:300])]
    elif name == "bit63_keys":
        k28 = _encodings(rng, 1500, span=28)
        k28[::2] |= np.uint64(1 << 63)
        keys = k28
        adds = [(keys, np.ones(len(keys), bool))]
    elif name == "masked":
        adds = [(keys, rng.random(len(keys)) < 0.7)]
    elif name == "all_masked":
        adds = [(keys, np.zeros(len(keys), bool))]
    elif name == "n0":
        adds = [(keys[:0], ones[:0])]
    elif name == "saturate_300":
        one = np.repeat(keys[:1], 300)
        adds = [(one, np.ones(300, bool)),
                (np.repeat(keys[1:2], 100), np.ones(100, bool)),
                (np.repeat(keys[1:2], 100), np.ones(100, bool)),
                (np.repeat(keys[1:2], 100), np.ones(100, bool))]
    elif name == "heavy_duplicates":
        dup = rng.integers(1, 40, size=4096, dtype=np.uint64)
        adds = [(dup, rng.random(4096) < 0.8), (dup[:100], np.ones(100, bool))]
        keys = np.concatenate([dup, keys[:100]])
    else:
        raise KeyError(name)
    return adds, keys


# ------------------------------------------------------------------- murmur3

def test_murmur3_matches_jax_on_1e5_keys_half_with_bit63():
    import jax.numpy as jnp

    from varigraph_tpu.ops.murmur3 import murmur3_x64_128_u64key as jax_murmur

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 63, size=100_000, dtype=np.uint64)
    keys[::2] |= np.uint64(1 << 63)
    for seed in (0, 1, 0xDEADBEEF, (1 << 40) + 17, (1 << 64) - 5):
        want = np.asarray(jax_murmur(jnp.asarray(keys), seed))
        got = murmur3_x64_128_u64key(_t(keys), seed).numpy().view(np.uint64)
        np.testing.assert_array_equal(got, want)


def test_murmur3_tensor_seeds_broadcast_like_scalar_seeds():
    rng = np.random.default_rng(1)
    keys = _t(rng.integers(0, np.iinfo(np.uint64).max, size=1000, dtype=np.uint64))
    seeds = make_seeds(5, seed=3)
    rows = murmur3_x64_128_u64key(keys[None, :], _t(seeds)[:, None])
    for i, s in enumerate(seeds.tolist()):
        torch.testing.assert_close(rows[i], murmur3_x64_128_u64key(keys, s),
                                   rtol=0, atol=0)


# -------------------------------------------------------------------- sizing

@pytest.mark.parametrize("n", [1, 100, 2000, 2_000_000 - 26, 100_000_000 - 26])
def test_sizing_and_seeds_match_jax(n):
    from varigraph_tpu.ops import cbf as jcbf

    assert cbf_size(n, 0.01) == jcbf.cbf_size(n, 0.01)
    m = 1
    while m < cbf_size(n, 0.01):
        m *= 2
    assert cbf_num_hashes(n, m) == jcbf.cbf_num_hashes(n, m)
    kh = cbf_num_hashes(n, m)
    np.testing.assert_array_equal(make_seeds(kh, 7), jcbf.make_seeds(kh, 7))
    if n <= 2000:  # small enough to allocate both filters
        a, b = CountingBloomFilter(n, 0.01, 7), jcbf.CountingBloomFilter(n, 0.01, 7)
        assert (a.size, a.num_hashes) == (b.size, b.num_hashes)
        np.testing.assert_array_equal(a.seeds, b.seeds)
        assert a.filter.dtype == torch.uint8 and a.filter.shape == (a.size,)


# ------------------------------------------------------------ add and count

@pytest.mark.parametrize("name", CASES)
def test_filter_and_counts_match_jax(name):
    from varigraph_tpu.ops.cbf import CountingBloomFilter as JaxCBF

    adds, queries = _case(name)
    a = CountingBloomFilter(N_FILTER, 0.01, seed=42)
    b = JaxCBF(N_FILTER, 0.01, seed=42)
    for keys, mask in adds:
        a.add(keys, mask)
        b.add(keys, mask)
        np.testing.assert_array_equal(a.filter.numpy(), np.asarray(b.filter))
    np.testing.assert_array_equal(a.count(queries), b.count(queries))
    assert a.count(queries).dtype == np.uint8
    assert a.occupancy() == pytest.approx(b.occupancy(), abs=0)
    if name == "saturate_300":
        assert a.count(queries[:2]).tolist() == [255, 255]
    if name in ("all_masked", "n0"):
        assert int(a.filter.sum()) == 0


def test_add_takes_tensors_and_numpy_alike():
    adds, queries = _case("masked")
    a = CountingBloomFilter(N_FILTER, 0.01, seed=1)
    b = CountingBloomFilter(N_FILTER, 0.01, seed=1)
    for keys, mask in adds:
        a.add(keys, mask)
        b.add(_t(keys), torch.from_numpy(mask))
    assert torch.equal(a.filter, b.filter)
    np.testing.assert_array_equal(a.count(queries), b.count(_t(queries)))


def test_plain_add_is_a_per_element_saturating_increment():
    """cbf_add_plain against a per-element loop of min(v + 1, 255)."""
    rng = np.random.default_rng(8)
    m = 1 << 10
    seeds = _t(make_seeds(4, seed=9))
    keys = rng.integers(1, 40, size=512, dtype=np.uint64)  # heavy duplicates
    mask = rng.random(512) < 0.8
    filt = torch.from_numpy(rng.integers(200, 256, size=m).astype(np.uint8))
    sim = filt.numpy().astype(np.int64)
    pos = (murmur3_x64_128_u64key(_t(keys)[None, :], seeds[:, None]) & (m - 1)).numpy()
    for j in range(len(keys)):
        if mask[j]:
            for p in pos[:, j]:
                sim[p] = min(sim[p] + 1, 255)
    cbf_add_plain(filt, _t(keys), torch.from_numpy(mask), seeds)
    np.testing.assert_array_equal(filt.numpy(), sim)
    np.testing.assert_array_equal(cbf_count_plain(filt, _t(keys), seeds).numpy(),
                                  sim[pos].min(axis=0))


# ------------------------------------------------------- state and persistence

def test_from_state_carries_jax_filter():
    from varigraph_tpu.ops.cbf import CountingBloomFilter as JaxCBF

    adds, queries = _case("random")
    b = JaxCBF(N_FILTER, 0.01, seed=5)
    for keys, mask in adds:
        b.add(keys, mask)
    a = CountingBloomFilter.from_state(b.size, b.num_hashes, b.seeds,
                                       np.asarray(b.filter))
    np.testing.assert_array_equal(a.count(queries), b.count(queries))
    # the state goes on: one more add on each side stays equal
    a.add(queries[:50])
    b.add(queries[:50])
    np.testing.assert_array_equal(a.filter.numpy(), np.asarray(b.filter))


@pytest.mark.parametrize("bad", ["size_not_pow2", "filter_length", "seed_count"])
def test_from_state_rejects_inconsistent_state(bad):
    size, kh = 1 << 10, 3
    seeds, filt = make_seeds(kh, 0), np.zeros(size, np.uint8)
    if bad == "size_not_pow2":
        size, filt = 1000, np.zeros(1000, np.uint8)
    elif bad == "filter_length":
        filt = filt[:-1]
    else:
        kh = 4
    with pytest.raises(ValueError):
        CountingBloomFilter.from_state(size, kh, seeds, filt)


def test_save_load_roundtrips_between_packages(tmp_path):
    from varigraph_tpu.ops.cbf import CountingBloomFilter as JaxCBF

    adds, queries = _case("masked")
    a = CountingBloomFilter(N_FILTER, 0.01, seed=3)
    for keys, mask in adds:
        a.add(keys, mask)
    p_torch = str(tmp_path / "torch_bf.npz")
    a.save(p_torch)
    a2 = CountingBloomFilter.load(p_torch)
    assert torch.equal(a2.filter, a.filter)
    assert (a2.size, a2.num_hashes) == (a.size, a.num_hashes)
    np.testing.assert_array_equal(a2.seeds, a.seeds)
    # the JAX package reads the port's file, and the port reads the JAX one
    j = JaxCBF.load(p_torch)
    np.testing.assert_array_equal(j.count(queries), a.count(queries))
    p_jax = str(tmp_path / "jax_bf.npz")
    j.save(p_jax)
    a3 = CountingBloomFilter.load(p_jax)
    np.testing.assert_array_equal(a3.filter.numpy(), a.filter.numpy())
    with np.load(p_torch) as z_t, np.load(p_jax) as z_j:
        assert sorted(z_t.files) == sorted(z_j.files)
        for f in z_t.files:
            assert z_t[f].dtype == z_j[f].dtype, f


# ------------------------------------------------------------------ wrappers

def test_wrappers_on_cpu_use_plain_and_count_no_launch():
    adds, queries = _case("random")
    bf = CountingBloomFilter(N_FILTER, 0.01, seed=2)
    ref = bf.filter.clone()
    before = dict(cbf_cuda.LAUNCHES)
    for keys, mask in adds:
        cbf_cuda.cbf_add_(bf.filter, _t(keys), torch.from_numpy(mask), bf.seeds_t)
        cbf_add_plain(ref, _t(keys), torch.from_numpy(mask), bf.seeds_t)
    assert torch.equal(bf.filter, ref)
    torch.testing.assert_close(cbf_cuda.cbf_count(bf.filter, _t(queries), bf.seeds_t),
                               cbf_count_plain(ref, _t(queries), bf.seeds_t),
                               rtol=0, atol=0)
    assert dict(cbf_cuda.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["filter_dtype", "keys_dtype", "mask_dtype",
                                 "mask_shape", "not_pow2", "strided", "2d",
                                 "no_seeds", "shard_past_m", "negative_lo"])
def test_wrappers_reject_bad_arguments(bad):
    filt = torch.zeros(1 << 10, dtype=torch.uint8)
    keys = _t(np.arange(1, 65, dtype=np.uint64))
    mask = torch.ones(64, dtype=torch.bool)
    seeds = _t(make_seeds(3, 0))
    shard = {}
    if bad == "filter_dtype":
        filt = filt.to(torch.int32)
    elif bad == "keys_dtype":
        keys = keys.to(torch.float64)
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "mask_shape":
        mask = mask[:-1]
    elif bad == "not_pow2":
        # a 1000-cell filter is valid (modulo addressing), but not as the
        # cells from 1 of a 1000-cell filter
        filt = torch.zeros(1000, dtype=torch.uint8)
        shard = {"m": 1000, "lo": 1}
    elif bad == "strided":
        keys, mask = keys[::2], mask[::2]
    elif bad == "2d":
        keys, mask = keys.reshape(8, 8), mask.reshape(8, 8)
    elif bad == "no_seeds":
        seeds = seeds[:0]
    elif bad == "shard_past_m":
        shard = {"m": 1 << 10, "lo": 1 << 9}
    elif bad == "negative_lo":
        shard = {"m": 1 << 11, "lo": -1}
    with pytest.raises((TypeError, ValueError)):
        cbf_cuda.cbf_add_(filt, keys, mask, seeds, **shard)
    if bad not in ("mask_dtype", "mask_shape"):
        with pytest.raises((TypeError, ValueError)):
            cbf_cuda.cbf_count(filt, keys, seeds, **shard)


@pytest.mark.parametrize("m", [1000, 3 * (1 << 10) + 1])
def test_plain_modulo_addressing_is_unsigned(m):
    """For m not a power of two, positions are the unsigned 64-bit Murmur3
    value % m (JAX ``_positions``); half the keys have bit 63 set, and so do
    about half the hashes."""
    from varigraph_tpu_torch.ops.cbf import cbf_positions

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 63, size=3000, dtype=np.uint64)
    keys[::2] |= np.uint64(1 << 63)
    seeds = make_seeds(3, 1)
    got = cbf_positions(_t(keys), _t(seeds), m).numpy()
    want = np.stack([murmur3_x64_128_u64key(_t(keys), int(s)).numpy()
                     .view(np.uint64) % np.uint64(m) for s in seeds])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got >= 0).all() and (got < m).all()


# ------------------------------------------------------- exact genome counts

def _exact_case():
    rng = np.random.default_rng(13)
    # a random core plus a 300x-repeated motif to exercise the 255 cap
    seq = ("".join(rng.choice(list("ACGT"), size=3000))
           + "ACGTTGCACCGTTGAACGGTTGCACCA" * 300)
    return rng, {"chr1": seq, "chr2": seq[:500]}


def test_exact_counter_matches_jax_and_brute_force():
    from varigraph_tpu.ops.exact_count import ExactGenomeCounter as JaxExact
    from varigraph_tpu.ops.sketch_ref import sketch_ref

    rng, genome = _exact_case()
    k = 27
    uniq, true_counts = np.unique(
        np.array([v for s in genome.values() for v in sketch_ref(s, k)], np.uint64),
        return_counts=True)
    present = uniq[rng.permutation(len(uniq))[:200]]
    absent = rng.integers(1, 1 << 50, size=100, dtype=np.uint64) << np.uint64(8)
    queries = np.concatenate([present, absent, present[:7]])  # incl. dups
    n = sum(len(s) for s in genome.values()) - k + 1

    got = ExactGenomeCounter(genome, k).count(queries)
    want = np.minimum(true_counts[np.searchsorted(uniq, present)], 255)
    np.testing.assert_array_equal(got[:200], want)
    assert (got[200:300] == 0).all()
    np.testing.assert_array_equal(got[300:], want[:7])
    assert (want == 255).any()  # the cap was exercised
    np.testing.assert_array_equal(got, JaxExact(genome, n=n, k=k).count(queries))
    # the sorted-unique fast path gives the same counts
    np.testing.assert_array_equal(ExactGenomeCounter(genome, k).count(uniq),
                                  np.minimum(true_counts, 255).astype(np.uint8))


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the filter kernel has no CPU mode")
    adds, queries = _case(name)
    gpu = CountingBloomFilter(N_FILTER, 0.01, seed=42, device="cuda")
    cpu = CountingBloomFilter(N_FILTER, 0.01, seed=42)
    before = dict(cbf_cuda.LAUNCHES)
    launched = 0
    for keys, mask in adds:
        gpu.add(keys, mask)
        cpu.add(keys, mask)
        launched += len(keys) > 0
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gpu.filter.cpu().numpy(), cpu.filter.numpy())
    np.testing.assert_array_equal(gpu.count(queries), cpu.count(queries))
    assert cbf_cuda.LAUNCHES["cbf_add"] == before.get("cbf_add", 0) + launched
    assert cbf_cuda.LAUNCHES["cbf_count"] == before.get("cbf_count", 0) + 1


@pytest.mark.cuda
def test_cuda_exact_counter_matches_plain_join():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the join kernel has no CPU mode")
    from varigraph_tpu_torch.ops.kmer import sketch_seq

    _, genome = _exact_case()
    k = 27
    absent = np.arange(1, 1000, dtype=np.uint64) << np.uint64(8)
    keys = np.unique(np.concatenate([absent, sketch_seq(genome["chr1"], k)]))
    kernel = ExactGenomeCounter(genome, k, device="cuda").count(keys)
    plain = ExactGenomeCounter(genome, k, device="cuda", join=count_join).count(keys)
    np.testing.assert_array_equal(kernel, plain)
    np.testing.assert_array_equal(kernel, ExactGenomeCounter(genome, k).count(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 3])
def test_cuda_shard_kernel_matches_plain(n_shards):
    """ShardedCBF over n logical shards of the card against the same filter
    over n shards of the CPU (the plain version): at 3 shards m = 2^15 + 1,
    positions are taken modulo m and a shard holds 10,923 cells, not a
    multiple of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the filter kernel has no CPU mode")
    from varigraph_tpu_torch.ops.cbf import ShardedCBF
    from varigraph_tpu_torch.parallel.mesh import Mesh

    for name in CASES:
        adds, queries = _case(name)
        gpu = ShardedCBF(N_FILTER, 0.01, seed=42, mesh=Mesh(["cuda"] * n_shards))
        cpu = ShardedCBF(N_FILTER, 0.01, seed=42, mesh=Mesh(["cpu"] * n_shards))
        assert gpu.size == (1 << 15) + (n_shards == 3)
        before = dict(cbf_cuda.LAUNCHES)
        launched = 0
        for keys, mask in adds:
            gpu.add(keys, mask)
            cpu.add(keys, mask)
            launched += n_shards * (len(keys) > 0)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(gpu.filter_np(), cpu.filter_np(), err_msg=name)
        np.testing.assert_array_equal(gpu.count(queries), cpu.count(queries),
                                      err_msg=name)
        assert gpu.occupancy() == cpu.occupancy()
        assert cbf_cuda.LAUNCHES["cbf_add"] == before.get("cbf_add", 0) + launched
        assert cbf_cuda.LAUNCHES["cbf_count"] == before.get("cbf_count", 0) + n_shards
