"""Counting Bloom filter over a uint8 counter tensor on the device.

Port of ``CountingBloomFilter`` of ``varigraph_tpu/ops/cbf.py`` (itself the
reference's include/counting_bloom_filter.hpp + src/counting_bloom_filter.cpp):

  * sizing as in the reference (:70-77) and the JAX package:
      m  = ceil(n * ln p / ln(1 / 2^ln2)), rounded UP to a power of two
      kh = round(m * ln 2 / n)          (round = half away from zero)
    The power-of-two size is the JAX package's deviation (its filter shapes
    and bit-and addressing); keeping it keeps the filter contents, and so the
    .vgt, bit for bit equal to the JAX package's.  Only power-of-two m is
    supported.
  * per-key positions = Murmur3 x64_128 (h1 + h2) & (m - 1), one per seed
    (:90-98), the seed truncated to its low 32 bits; seeds from a seeded
    PCG64 stream (``make_seeds``), so construct runs are reproducible.
  * ``add`` saturates counters at 255 (:28-36); ``count`` is the minimum
    counter over the kh positions (:51-67).

Saturating +1 steps commute -- min(255, v+a+b) does not depend on the order
of the steps -- so any order of updates gives the same filter.

The plain torch versions (``cbf_add_plain``, ``cbf_count_plain``) are beside
the class; ``ops/cbf_cuda.py`` wraps the CUDA kernel (csrc/cbf.cu) that the
class launches on CUDA tensors, and that falls to the plain version only for
CPU tensors.
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

def cbf_positions(keys: torch.Tensor, seeds: torch.Tensor, m: int) -> torch.Tensor:
    """int64 [N] keys x int64 [kh] seeds -> int64 [kh, N] filter positions
    (m a power of two)."""
    return murmur3_x64_128_u64key(keys[None, :], seeds[:, None]) & (m - 1)


def cbf_add_plain(filter: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                  seeds: torch.Tensor) -> None:
    """Saturating filter[p] += 1 for every position p of every key whose mask
    is set, in place: the positions' multiplicities from ``torch.unique``,
    then filter[u] = min(filter[u] + count, 255).  Needs no m-sized
    histogram."""
    pos = cbf_positions(keys[mask], seeds, filter.numel()).reshape(-1)
    if pos.numel() == 0:
        return
    u, c = torch.unique(pos, return_counts=True)
    filter[u] = (filter[u].to(torch.int64) + c).clamp_(max=255).to(torch.uint8)


def cbf_count_plain(filter: torch.Tensor, keys: torch.Tensor,
                    seeds: torch.Tensor) -> torch.Tensor:
    """uint8 [N]: the minimum counter over each key's kh positions."""
    return filter[cbf_positions(keys, seeds, filter.numel())].amin(dim=0)


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
        """uint64 numpy or int64 tensor -> contiguous int64 [N] on device."""
        if isinstance(hashes, torch.Tensor):
            return hashes.to(self.device, torch.int64).reshape(-1).contiguous()
        h = np.ascontiguousarray(hashes, dtype=np.uint64).reshape(-1)
        return torch.from_numpy(h.view(np.int64).copy()).to(self.device)

    # ------------------------------------------------------------------ ops
    def add(self, hashes, mask=None) -> None:
        """Saturating add of every key (where ``mask`` is set), in place."""
        from .cbf_cuda import cbf_add_  # cbf_cuda imports this module

        h = self._keys(hashes)
        if mask is None:
            m = torch.ones(h.shape, dtype=torch.bool, device=self.device)
        elif isinstance(mask, torch.Tensor):
            m = mask.to(self.device, torch.bool).reshape(-1).contiguous()
        else:
            m = torch.from_numpy(np.asarray(mask, bool).reshape(-1).copy()).to(self.device)
        cbf_add_(self.filter, h, m, self.seeds_t)

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
