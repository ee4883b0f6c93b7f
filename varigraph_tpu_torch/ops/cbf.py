"""Counting Bloom filter over a uint8 counter tensor on the device.

Port of ``CountingBloomFilter`` and ``ShardedCBF`` of
``varigraph_tpu/ops/cbf.py`` (itself the reference's
include/counting_bloom_filter.hpp + src/counting_bloom_filter.cpp):

  * sizing as in the reference (:70-77) and the JAX package:
      m  = ceil(n * ln p / ln(1 / 2^ln2)), rounded UP to a power of two
      kh = round(m * ln 2 / n)          (round = half away from zero)
    The power-of-two size is the JAX package's deviation (its filter shapes
    and bit-and addressing); keeping it keeps the filter contents, and so the
    .vgt, bit for bit equal to the JAX package's.  ``ShardedCBF`` pads that
    m up to a multiple of the mesh size, as the JAX one does, so on a mesh
    of a size that is not a power of two m is not one either.
  * per-key positions = Murmur3 x64_128 (h1 + h2) & (m - 1), one per seed
    (:90-98), the seed truncated to its low 32 bits -- or that hash % m, an
    unsigned modulo, when m is not a power of two (JAX ``_positions``,
    ops/cbf.py:56-59); seeds from a seeded PCG64 stream (``make_seeds``), so
    construct runs are reproducible.
  * ``add`` saturates counters at 255 (:28-36); ``count`` is the minimum
    counter over the kh positions (:51-67).

Saturating +1 steps commute -- min(255, v+a+b) does not depend on the order
of the steps -- so any order of updates gives the same filter.

The plain torch versions (``cbf_positions``, ``cbf_add_plain``,
``cbf_count_plain``) work on one shard ``[lo, lo + m_local)`` of a filter of
m cells; the single-device filter is the shard lo = 0, m_local = m.
``ops/cbf_cuda.py`` wraps the CUDA kernel (csrc/cbf.cu) that both classes
launch on CUDA tensors, and that falls to the plain version only for CPU
tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .murmur3 import murmur3_x64_128_u64key


def cbf_size(n: int, p: float) -> int:
    """m = ceil(n * ln p / ln(1 / 2^ln2)) (counting_bloom_filter.cpp:70-72)."""
    return int(math.ceil((n * math.log(p)) / math.log(1.0 / math.pow(2.0, math.log(2.0)))))


def cbf_num_hashes(n: int, m: int) -> int:
    """kh = round(m * ln2 / n), round half away from zero (:75-77)."""
    return int(math.floor(m * math.log(2.0) / n + 0.5))


def make_seeds(num_hashes: int, seed: int) -> np.ndarray:
    """Deterministic uint64 hash seeds in [1, 2^64)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(1, np.iinfo(np.uint64).max, size=num_hashes, dtype=np.uint64)


def _pow2_at_least(x: int) -> int:
    m = 1
    while m < x:
        m *= 2
    return m


# ------------------------------------------------------------ plain versions

def _umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned 64-bit h % m of int64 bit patterns, for 1 <= m < 2^62:
    torch's int64 % is signed, so split h = 2 * (h >>> 1) + (h & 1), whose
    parts are non-negative."""
    half = (h >> 1) & ((1 << 63) - 1)
    return (2 * (half % m) + (h & 1)) % m


def cbf_positions(keys: torch.Tensor, seeds: torch.Tensor, m: int) -> torch.Tensor:
    """int64 [N] keys x int64 [kh] seeds -> int64 [kh, N] positions in a
    filter of m cells: a mask when m is a power of two, else an unsigned
    modulo."""
    h = murmur3_x64_128_u64key(keys[None, :], seeds[:, None])
    return h & (m - 1) if m & (m - 1) == 0 else _umod(h, m)


def _local(keys: torch.Tensor, seeds: torch.Tensor, m: int, lo: int,
           m_local: int):
    """[kh, N] positions relative to the shard [lo, lo + m_local), and a
    bool [kh, N] of those that fall in it (None for the whole filter, where
    all do)."""
    pos = cbf_positions(keys, seeds, m)
    if lo == 0 and m_local == m:
        return pos, None
    rel = pos - lo
    return rel, (rel >= 0) & (rel < m_local)


def cbf_add_plain(filter: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                  seeds: torch.Tensor, m: int | None = None, lo: int = 0) -> None:
    """Saturating filter[p - lo] += 1 for every position p in the shard of
    every key whose mask is set, in place: the positions' multiplicities
    from ``torch.unique``, then filter[u] = min(filter[u] + count, 255).
    ``filter`` holds the cells [lo, lo + filter.numel()) of a filter of m
    cells (default: all of them).  Needs no m-sized histogram."""
    m = filter.numel() if m is None else m
    rel, inr = _local(keys[mask], seeds, m, lo, filter.numel())
    pos = (rel if inr is None else rel[inr]).reshape(-1)
    if pos.numel() == 0:
        return
    u, c = torch.unique(pos, return_counts=True)
    filter[u] = (filter[u].to(torch.int64) + c).clamp_(max=255).to(torch.uint8)


def cbf_count_plain(filter: torch.Tensor, keys: torch.Tensor,
                    seeds: torch.Tensor, m: int | None = None,
                    lo: int = 0) -> torch.Tensor:
    """uint8 [N]: the minimum counter over each key's positions in the shard
    (see ``cbf_add_plain``), 255 for a key with none there."""
    m = filter.numel() if m is None else m
    rel, inr = _local(keys, seeds, m, lo, filter.numel())
    if inr is None:
        return filter[rel].amin(dim=0)
    return torch.where(inr, filter[torch.where(inr, rel, 0)], 255).amin(dim=0)


def _as_keys(hashes, device) -> torch.Tensor:
    """uint64 numpy or int64 tensor -> contiguous int64 [N] on device."""
    if isinstance(hashes, torch.Tensor):
        return hashes.to(device, torch.int64).reshape(-1).contiguous()
    h = np.ascontiguousarray(hashes, dtype=np.uint64).reshape(-1)
    return torch.from_numpy(h.view(np.int64).copy()).to(device)


def _as_mask(mask, keys: torch.Tensor) -> torch.Tensor:
    """None (all set), a bool tensor or array -> contiguous bool [N] beside
    ``keys``."""
    if mask is None:
        return torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    if isinstance(mask, torch.Tensor):
        return mask.to(keys.device, torch.bool).reshape(-1).contiguous()
    return torch.from_numpy(np.asarray(mask, bool).reshape(-1).copy()).to(keys.device)


# ------------------------------------------------------------------ the filter

class CountingBloomFilter:
    """Counting Bloom filter with a uint8 counter tensor on ``device``."""

    def __init__(self, n: int, p: float = 0.01, seed: int = 0,
                 device: torch.device | str = "cpu"):
        self.size = _pow2_at_least(cbf_size(n, p))
        self.num_hashes = cbf_num_hashes(n, self.size)
        self.seeds = make_seeds(self.num_hashes, seed)
        self.filter = torch.zeros(self.size, dtype=torch.uint8, device=device)
        self.seeds_t = self._seed_tensor(self.seeds, device)

    @staticmethod
    def _seed_tensor(seeds: np.ndarray, device) -> torch.Tensor:
        s = np.ascontiguousarray(seeds, dtype=np.uint64).view(np.int64).copy()
        return torch.from_numpy(s).to(device)

    @classmethod
    def from_state(cls, size: int, num_hashes: int, seeds: np.ndarray,
                   filter: np.ndarray,
                   device: torch.device | str = "cpu") -> "CountingBloomFilter":
        """A filter from host state: the JAX object's (size, num_hashes,
        seeds, filter) as numpy, or the members of a saved filter."""
        size, num_hashes = int(size), int(num_hashes)
        seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1)
        filter = np.asarray(filter, dtype=np.uint8).reshape(-1)
        if size < 1 or size & (size - 1):
            raise ValueError(f"filter size must be a power of two, got {size}")
        if len(filter) != size:
            raise ValueError(f"filter has {len(filter)} counters for size {size}")
        if len(seeds) != num_hashes:
            raise ValueError(f"{len(seeds)} seeds for {num_hashes} hash functions")
        bf = cls.__new__(cls)
        bf.size, bf.num_hashes, bf.seeds = size, num_hashes, seeds.copy()
        bf.filter = torch.from_numpy(filter.copy()).to(device)
        bf.seeds_t = cls._seed_tensor(seeds, device)
        return bf

    @property
    def device(self) -> torch.device:
        return self.filter.device

    def _keys(self, hashes) -> torch.Tensor:
        return _as_keys(hashes, self.device)

    # ------------------------------------------------------------------ ops
    def add(self, hashes, mask=None) -> None:
        """Saturating add of every key (where ``mask`` is set), in place."""
        from .cbf_cuda import cbf_add_  # cbf_cuda imports this module

        h = self._keys(hashes)
        cbf_add_(self.filter, h, _as_mask(mask, h), self.seeds_t)

    def count(self, hashes) -> np.ndarray:
        """uint8 [N] counts on the host."""
        from .cbf_cuda import cbf_count

        return cbf_count(self.filter, self._keys(hashes), self.seeds_t).cpu().numpy()

    def occupancy(self) -> float:
        """Fraction of nonzero counters (reference get_cap, :100-115)."""
        return int(torch.count_nonzero(self.filter)) / self.size

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            size=np.uint64(self.size),
            num_hashes=np.uint32(self.num_hashes),
            seeds=self.seeds,
            filter=self.filter.cpu().numpy(),
        )

    @classmethod
    def load(cls, path: str,
             device: torch.device | str = "cpu") -> "CountingBloomFilter":
        with np.load(path) as z:
            return cls.from_state(int(z["size"]), int(z["num_hashes"]),
                                  z["seeds"], z["filter"], device)


class ShardedCBF:
    """A counting Bloom filter whose counters are split by position range
    over the devices of a mesh (port of ``ShardedCBF``,
    varigraph_tpu/ops/cbf.py:331-395, with the shard_map bodies of
    varigraph_tpu/parallel/mesh.py:205-309).

    Same sizing, seeds and counts as ``CountingBloomFilter``, except that m
    is padded up to a multiple of the mesh size: on a mesh whose size is not
    a power of two, positions are then taken modulo m.  Shard i holds the
    cells [i * m / D, (i + 1) * m / D) on mesh device i; a mesh may name one
    device several times (logical shards).  ``add`` sends every key to every
    shard, and each shard updates only its own cells (no collective); a
    shard's ``count`` is 255 where none of a key's positions is its own, and
    the count is the elementwise minimum of the shards' counts, taken on the
    first mesh device."""

    def __init__(self, n: int, p: float = 0.01, seed: int = 0, *, mesh):
        n_dev = len(mesh.devices)
        m = _pow2_at_least(cbf_size(n, p))
        m += (-m) % n_dev  # a mesh of another size than 2^j: a multiple of it
        self.size = m
        self.num_hashes = cbf_num_hashes(n, m)
        self.seeds = make_seeds(self.num_hashes, seed)
        self.mesh = mesh
        self.m_local = m // n_dev
        self.los = [i * self.m_local for i in range(n_dev)]
        # each shard's allocation is rounded up to whole 32-bit words: the
        # kernel updates a byte through the word that holds it
        words = -(-self.m_local // 4)
        self.shards = [
            torch.zeros(4 * words, dtype=torch.uint8, device=d)[: self.m_local]
            for d in mesh.devices
        ]
        self.seeds_t = [CountingBloomFilter._seed_tensor(self.seeds, d)
                        for d in mesh.devices]

    def add(self, hashes, mask=None) -> None:
        """Saturating add of every key (where ``mask`` is set), in place."""
        from .cbf_cuda import cbf_add_

        h = _as_keys(hashes, self.shards[0].device)
        mask = _as_mask(mask, h)
        for shard, lo, seeds in zip(self.shards, self.los, self.seeds_t):
            cbf_add_(shard, h.to(shard.device), mask.to(shard.device), seeds,
                     self.size, lo)

    def count(self, hashes) -> np.ndarray:
        """uint8 [N] counts on the host."""
        from .cbf_cuda import cbf_count

        first = self.shards[0].device
        h = _as_keys(hashes, first)
        out = None
        for shard, lo, seeds in zip(self.shards, self.los, self.seeds_t):
            c = cbf_count(shard, h.to(shard.device), seeds, self.size, lo).to(first)
            out = c if out is None else torch.minimum(out, c)
        return out.cpu().numpy()

    def find(self, hashes) -> np.ndarray:
        return self.count(hashes) > 0

    def occupancy(self) -> float:
        """Fraction of nonzero counters, summed over the shards."""
        return sum(int(torch.count_nonzero(s)) for s in self.shards) / self.size

    def filter_np(self) -> np.ndarray:
        """The whole filter, [m] uint8 on the host (tests and checks)."""
        return np.concatenate([s.cpu().numpy() for s in self.shards])
