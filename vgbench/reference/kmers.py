"""Canonical k-mers, Murmur3 and the counting Bloom filter, in plain torch.

The semantics are upstream varigraph's (``src/kmer.cpp:20-52``,
``include/hash64.hpp``, ``src/MurmurHash3.cpp``,
``src/counting_bloom_filter.cpp``), written here without a loop over
positions: with no ambiguous base in a segment, the two rolling registers at
position i are sums over the last k bases of the segment, so they come out
of k shifted adds over all positions at once.

  forward register  sum_t c[i-t] << 2t                (bases before the
  reverse register  sum_t (3 - c[i-t]) << 2(k-1-t)     segment count 0)

A position emits when its registers differ and at least k positions of the
segment up to it had registers that differ (a palindromic window is skipped
without advancing the run counter).  The emitted value is
``hash64(min(fwd, rev)) << 8 | k``.  Values are uint64 bit patterns held in
int64; at k <= 27 they are below 2^62.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ACGT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ACGT[_b] = _i
    ACGT[ord(chr(_b).lower())] = _i


def encode(seq: np.ndarray | bytes) -> np.ndarray:
    """ASCII bases -> codes 0..3; any other byte raises (the benchmark's
    data holds no ambiguous base)."""
    a = np.frombuffer(seq, np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    c = ACGT[a]
    if (c == 255).any():
        raise ValueError("an ambiguous base in the reference's input")
    return c


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def segment_kmers(codes: torch.Tensor, offsets: torch.Tensor, k: int,
                  chunk: int = 1 << 24):
    """Emitted canonical k-mers of the segments ``codes[offsets[s]:offsets[s+1]]``.

    codes: int64 or uint8 [T] (0..3); offsets: int64 [S + 1].  Returns
    (values int64 [E], segment int64 [E]) in position order.  Works a
    block of whole segments (at most about ``chunk`` positions) at a time."""
    if not 0 < k <= 28:
        raise ValueError(f"k must be in 1..28, got {k}")
    dev = codes.device
    offsets = offsets.to(dev, torch.int64)
    S = offsets.numel() - 1
    out_v, out_s = [], []
    mask = (1 << (2 * k)) - 1
    off_h = offsets.cpu().numpy()
    s0 = 0
    while s0 < S:
        # whole segments up to ~chunk positions (at least one)
        s1 = int(np.searchsorted(off_h, off_h[s0] + chunk, side="right")) - 1
        s1 = min(max(s1, s0 + 1), S)
        a, b = int(off_h[s0]), int(off_h[s1])
        c = codes[a:b].to(torch.int64)
        seg = torch.repeat_interleave(
            torch.arange(s0, s1, device=dev),
            offsets[s0 + 1 : s1 + 1] - offsets[s0:s1])
        j = torch.arange(a, b, device=dev) - offsets[seg]   # position in segment
        fwd = torch.zeros_like(c)
        rev = torch.zeros_like(c)
        for t in range(k):
            ct = c if t == 0 else torch.cat([c.new_zeros(t), c[:-t]])
            valid = j >= t
            fwd += torch.where(valid, ct << (2 * t), 0)
            rev += torch.where(valid, (3 - ct) << (2 * (k - 1 - t)), 0)
        fwd &= mask
        step = (fwd != rev).to(torch.int64)
        cs = torch.cumsum(step, 0)
        # positions of the segment up to i whose registers differ
        start_idx = offsets[seg] - a
        run = cs - (cs[start_idx] - step[start_idx])
        emit = (step == 1) & (run >= k)
        canon = torch.minimum(fwd, rev)[emit]
        out_v.append((hash64(canon, mask) << 8) | k)
        out_s.append(seg[emit])
        s0 = s1
    if not out_v:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    return torch.cat(out_v), torch.cat(out_s)


# ------------------------------------------------------------- Murmur3 x64_128

def _i64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_C1 = _i64(0x87C37B91114253D5)
_C2 = _i64(0x4CF5AD432745937F)
_F1 = _i64(0xFF51AFD7ED558CCD)
_F2 = _i64(0xC4CEB9FE1A85EC53)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _F1
    h = h ^ _shr(h, 33)
    h = h * _F2
    return h ^ _shr(h, 33)


def murmur3_u64(key: torch.Tensor, seed: int) -> torch.Tensor:
    """h1 + h2 of MurmurHash3_x64_128 over the 8 bytes of each key, with the
    low 32 bits of ``seed`` (the upstream filter passes an unsigned int)."""
    s = int(seed) & 0xFFFFFFFF
    k1 = key * _C1
    k1 = (k1 << 31) | _shr(k1, 33)
    k1 = k1 * _C2
    h1 = (k1 ^ s) ^ 8
    h2 = torch.full_like(h1, s ^ 8)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1 + h2


class BloomCounts:
    """The genome's counting Bloom filter (p = 0.01): m the power of two at
    or above ceil(n ln p / ln(2^-ln2)), kh = round(m ln2 / n), seeds from
    PCG64(seed), counters saturating at 255, a key's count the minimum of
    its counters."""

    def __init__(self, n: int, seed: int, device, p: float = 0.01):
        m_est = int(math.ceil(n * math.log(p) / math.log(1.0 / 2.0 ** math.log(2.0))))
        self.m = 1 << max(0, (m_est - 1).bit_length())
        self.kh = int(math.floor(self.m * math.log(2.0) / n + 0.5))
        rng = np.random.Generator(np.random.PCG64(seed))
        self.seeds = [int(x) for x in rng.integers(
            1, np.iinfo(np.uint64).max, size=self.kh, dtype=np.uint64)]
        self.counts = torch.zeros(self.m, dtype=torch.int32, device=device)

    def _positions(self, keys: torch.Tensor):
        for s in self.seeds:
            yield murmur3_u64(keys, s) & (self.m - 1)

    def add(self, keys: torch.Tensor) -> None:
        for pos in self._positions(keys):
            self.counts += torch.bincount(pos, minlength=self.m).to(torch.int32)
        self.counts.clamp_(max=255)

    def count(self, keys: torch.Tensor) -> torch.Tensor:
        out = torch.full(keys.shape, 255, dtype=torch.int32, device=keys.device)
        for pos in self._positions(keys):
            out = torch.minimum(out, self.counts[pos])
        return out
