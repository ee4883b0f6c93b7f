"""The counting join: cov[i] += #{j : mask[j] and queries[j] == keys[i]}.

The plain torch join (varigraph_tpu_torch/ops/table.count_join) must equal
the JAX package's two-sort count_merge and its Pallas banded join
(count_merge_banded, run in interpret mode as tests/test_table.py does) on
the cases chip_smoke.py runs on the card, at small sizes.  The CUDA kernel
(ops/join_cuda.count_join_) is held against the plain join on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from varigraph_tpu_torch.ops import join_cuda  # noqa: E402
from varigraph_tpu_torch.ops.table import count_join  # noqa: E402

# The JAX side is imported inside the tests that use it: the machine with the
# card has no JAX, and runs the kernel cases of this file alone with
#   python -m pytest --noconftest -m cuda tests/test_torch_join.py


def _vals(rng, n, span=27):
    return (rng.integers(0, 1 << 50, size=n, dtype=np.uint64)
            << np.uint64(8)) | np.uint64(span)


def _with_hits(rng, keys, n, hit_rate, mask_rate):
    q = _vals(rng, n)
    if len(keys):
        hit = rng.random(n) < hit_rate
        q[hit] = keys[rng.integers(0, len(keys), size=int(hit.sum()))]
    return q, rng.random(n) < mask_rate


CASES = ["random", "m_not_multiple_of_128", "bit63_keys", "repeated_key",
         "all_masked", "m0", "q0"]


def _case(name):
    """(keys u64 sorted unique, queries u64, mask bool) of one case."""
    rng = np.random.default_rng(CASES.index(name))
    keys = np.unique(_vals(rng, 300))
    if name == "random":
        q, m = _with_hits(rng, keys, 4096, 0.3, 0.9)
    elif name == "m_not_multiple_of_128":
        keys = keys[:203]
        q, m = _with_hits(rng, keys, 4096, 0.3, 0.9)
    elif name == "bit63_keys":
        k28 = _vals(rng, 300, span=28)
        k28[::2] |= np.uint64(1 << 63)
        keys = np.unique(k28)
        q, m = _with_hits(rng, keys, 4096, 0.5, 0.9)
    elif name == "repeated_key":
        q = np.full(3 * 4096 + 1, keys[3], np.uint64)
        m = np.ones(len(q), bool)
    elif name == "all_masked":
        q, _ = _with_hits(rng, keys, 4096, 0.5, 1.0)
        m = np.zeros(len(q), bool)
    elif name == "m0":
        keys = keys[:0]
        q, m = _with_hits(rng, keys, 4096, 0.0, 1.0)
    elif name == "q0":
        q, m = np.empty(0, np.uint64), np.empty(0, bool)
    else:
        raise KeyError(name)
    return keys, q, m


def _torch_join(fn, keys, q, m, device="cpu"):
    cov = torch.zeros(len(keys), dtype=torch.int32, device=device)
    fn(cov,
       torch.from_numpy(keys.view(np.int64)).to(device),
       torch.from_numpy(q.view(np.int64)).to(device),
       torch.from_numpy(m).to(device))
    return cov.cpu().numpy()


def _jax_join(name, keys, q, m, **kw):
    import jax.numpy as jnp

    from varigraph_tpu.ops import join_pallas, table

    fn = {"count_merge": table.count_merge,
          "count_merge_banded": join_pallas.count_merge_banded}[name]
    cov = fn(jnp.zeros(len(keys), jnp.uint32), jnp.asarray(keys),
             jnp.asarray(q), jnp.asarray(m), **kw)
    return np.asarray(cov).astype(np.int64)


@pytest.mark.parametrize("name", CASES)
def test_plain_join_matches_two_sort_join(name):
    keys, q, m = _case(name)
    got = _torch_join(count_join, keys, q, m)
    if len(keys) == 0:
        assert got.shape == (0,)
        return
    np.testing.assert_array_equal(got, _jax_join("count_merge", keys, q, m))


@pytest.mark.parametrize("name", ["random", "m_not_multiple_of_128",
                                  "bit63_keys", "repeated_key", "all_masked"])
def test_plain_join_matches_pallas_banded_join(name):
    """The Pallas kernel in interpret mode; "repeated_key" overflows its two
    query tiles and takes its two-sort fallback."""
    keys, q, m = _case(name)
    want = _jax_join("count_merge_banded", keys, q, m, interpret=True)
    np.testing.assert_array_equal(_torch_join(count_join, keys, q, m), want)
    assert name == "all_masked" or want.sum() > 0


def test_wrapper_on_cpu_uses_plain_join_and_counts_no_launch():
    keys, q, m = _case("random")
    before = join_cuda.LAUNCHES["count_join"]
    np.testing.assert_array_equal(_torch_join(join_cuda.count_join_, keys, q, m),
                                  _torch_join(count_join, keys, q, m))
    assert join_cuda.LAUNCHES["count_join"] == before


def test_join_accumulates_in_place():
    keys, q, m = _case("random")
    cov = torch.full((len(keys),), 5, dtype=torch.int32)
    args = (torch.from_numpy(keys.view(np.int64)),
            torch.from_numpy(q.view(np.int64)), torch.from_numpy(m))
    join_cuda.count_join_(cov, *args)
    join_cuda.count_join_(cov, *args)
    once = _torch_join(count_join, keys, q, m)
    np.testing.assert_array_equal(cov.numpy(), 5 + 2 * once)


@pytest.mark.parametrize("bad", ["cov_dtype", "keys_dtype", "mask_dtype",
                                 "mask_shape", "cov_shape", "strided", "2d"])
def test_wrapper_rejects_bad_arguments(bad):
    keys, q, m = _case("random")
    cov = torch.zeros(len(keys), dtype=torch.int32)
    k = torch.from_numpy(keys.view(np.int64))
    qt = torch.from_numpy(q.view(np.int64))
    mt = torch.from_numpy(m)
    if bad == "cov_dtype":
        cov = cov.to(torch.int64)
    elif bad == "keys_dtype":
        k = k.to(torch.float64)
    elif bad == "mask_dtype":
        mt = mt.to(torch.uint8)
    elif bad == "mask_shape":
        mt = mt[:-1]
    elif bad == "cov_shape":
        cov = cov[:-1]
    elif bad == "strided":
        qt, mt = qt[::2], mt[::2]
    elif bad == "2d":
        qt, mt = qt.reshape(64, -1), mt.reshape(64, -1)
    with pytest.raises((TypeError, ValueError)):
        join_cuda.count_join_(cov, k, qt, mt)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain_join(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the join kernel has no CPU mode")
    keys, q, m = _case(name)
    before = join_cuda.LAUNCHES["count_join"]
    got = _torch_join(join_cuda.count_join_, keys, q, m, device="cuda")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, _torch_join(count_join, keys, q, m))
    launched = len(keys) > 0 and len(q) > 0
    assert join_cuda.LAUNCHES["count_join"] == before + launched
