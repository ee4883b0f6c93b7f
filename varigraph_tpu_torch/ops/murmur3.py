"""MurmurHash3 x64_128 specialized to 8-byte keys, on torch int64 tensors.

Port of ``varigraph_tpu/ops/murmur3.py``.  The reference hashes each 64-bit
k-mer encoding with MurmurHash3_x64_128 (reference src/MurmurHash3.cpp:256-332)
through BloomFilter::_murmur_hash (src/counting_bloom_filter.cpp:90-98), which
returns h1 + h2.  For an 8-byte key the algorithm has no body blocks and an
8-byte tail:

  h1 = h2 = seed            (only the low 32 bits: the reference's
                             _murmur_hash takes an `unsigned int seed`)
  k1 = key * c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1
  h1 ^= 8; h2 ^= 8; h1 += h2; h2 += h1
  h1 = fmix64(h1); h2 = fmix64(h2); h1 += h2; h2 += h1
  return h1 + h2

uint64 values are carried as int64 bit patterns.  Multiplies and adds wrap in
int64 exactly as in uint64; right shifts in int64 are arithmetic, so every
right shift here is masked to be logical.  This is the plain version of the
hash, and the one the CUDA filter kernel (csrc/cbf.cu) must equal.
"""

from __future__ import annotations

import torch


def _i64(u: int) -> int:
    """The int64 bit pattern of a uint64 constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


_C1 = _i64(0x87C37B91114253D5)
_C2 = _i64(0x4CF5AD432745937F)
_F1 = _i64(0xFF51AFD7ED558CCD)
_F2 = _i64(0xC4CEB9FE1A85EC53)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of a uint64 bit pattern held in int64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _F1
    h = h ^ _shr(h, 33)
    h = h * _F2
    h = h ^ _shr(h, 33)
    return h


def murmur3_x64_128_u64key(key: torch.Tensor, seed) -> torch.Tensor:
    """h1 + h2 of MurmurHash3_x64_128 over the 8 little-endian bytes of *key*.

    Args:
      key: int64 tensor (uint64 bit patterns) of any shape.
      seed: Python int or integer tensor broadcastable against ``key``; only
        its low 32 bits are used.
    Returns an int64 tensor holding the uint64 hash bit patterns.
    """
    if isinstance(seed, torch.Tensor):
        seed32 = seed.to(torch.int64) & 0xFFFFFFFF
    else:
        seed32 = int(seed) & 0xFFFFFFFF
    k1 = key.to(torch.int64) * _C1
    k1 = _rotl64(k1, 31)
    k1 = k1 * _C2
    h1 = (k1 ^ seed32) ^ 8
    h2 = torch.zeros_like(h1) + (seed32 ^ 8)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1 + h2
