"""The torch k-mer sketch (varigraph_tpu_torch/ops/kmer.py) must equal the
JAX package's (varigraph_tpu/ops/kmer.py) bit for bit: k-mer values, emit
masks, the 2-bit unpack and the host packer.  The torch side is the
reference's sequential rolling form; the JAX side an associative scan."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from varigraph_tpu.ops import kmer as jk  # noqa: E402
from varigraph_tpu_torch.ops import kmer as tk  # noqa: E402

KS = [5, 15, 27, 28]
B, L = 24, 96


def _rows(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] codes 0..4 and [B] lengths: random rows, N runs, palindromic
    repeats, a row of length 0 and an all-N row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    codes[1, 10:14] = 4                                   # N run
    codes[2, ::7] = 4                                     # scattered Ns
    codes[3] = np.tile([0, 1, 2, 3], L // 4)              # ACGT repeats
    codes[4] = np.tile([0, 0, 3, 3], L // 4)              # AATT repeats
    codes[5, :6] = [0, 1, 2, 1, 2, 3]                     # ACGCGT palindrome
    codes[6] = 4                                          # all ambiguous
    lens[0] = 0                                           # length 0
    lens[1:7] = L
    for r in range(B):
        codes[r, lens[r]:] = 4
    return codes, lens


def _jax_sketch(codes, k):
    v, e = jk.sketch_codes(jnp.asarray(codes), k)
    return np.asarray(v).view(np.int64), np.asarray(e)


@pytest.mark.parametrize("k", KS)
def test_sketch_codes_bit_exact(k):
    codes, _ = _rows(k)
    want_v, want_e = _jax_sketch(codes, k)
    got_v, got_e = tk.sketch_codes(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_e.any()


@pytest.mark.parametrize("k", KS)
def test_sketch_packed_bit_exact(k):
    """pack_codes_np -> unpack_2bit -> sketch, on both sides."""
    codes, lens = _rows(100 + k)
    # the packed feed carries prefix-valid rows (no interior Ns)
    prefix = np.where(np.arange(L)[None, :] < lens[:, None],
                      np.where(codes > 3, 0, codes), 4).astype(np.uint8)
    packed_j = jk.pack_codes_np(prefix, lens)
    packed_t = tk.pack_codes_np(prefix, lens)
    np.testing.assert_array_equal(packed_t, packed_j)

    unpacked_j = np.asarray(jk.unpack_2bit(jnp.asarray(packed_j)))
    unpacked_t = tk.unpack_2bit(torch.from_numpy(packed_t)).numpy()
    np.testing.assert_array_equal(unpacked_t, unpacked_j)

    v_j, e_j = jk.sketch_packed(jnp.asarray(packed_j), k)
    v_t, e_t = tk.sketch_packed(torch.from_numpy(packed_t), k)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j).view(np.int64))


def test_bit63_set_at_k28():
    """At k = 28 some encodings set bit 63: negative as int64, equal as bit
    patterns."""
    codes, _ = _rows(7)
    v, e = tk.sketch_codes(torch.from_numpy(codes), 28)
    vals = v[e]
    assert (vals < 0).any() and (vals > 0).any()
    assert ((vals & 0xFF) == 28).all()


def test_hash64_matches_host_oracle():
    from varigraph_tpu.ops.sketch_ref import hash64_np

    rng = np.random.default_rng(3)
    for k in KS:
        mask = (1 << (2 * k)) - 1
        xs = rng.integers(0, 1 << (2 * k), size=64, dtype=np.uint64)
        got = tk.hash64(torch.from_numpy(xs.view(np.int64)), mask).numpy()
        want = [hash64_np(int(x), mask) for x in xs]
        assert got.view(np.uint64).tolist() == want


def test_pack_codes_rejects_ragged_width():
    with pytest.raises(ValueError):
        tk.pack_codes_np(np.zeros((2, 6), np.uint8), np.zeros(2, np.int32))
