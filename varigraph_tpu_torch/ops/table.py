"""The k-mer table: sorted keys and coverage as torch tensors.

Port of ``varigraph_tpu/ops/table.py``, which replaces the reference's
central ``unordered_map<uint64_t, kmerCovFreBitVec>``
(include/construct_index.hpp:140) with structure-of-arrays state:

  keys     int64  [M] on device  uint64 k-mer encodings (hash64<<8|span) as
                                 int64 bit patterns, sorted by unsigned value
  cov      int32  [M] on device  read coverage 'c'; read saturated at 255
                                 (reference src/fastq_kmer.cpp:135)
  freq     uint8  [M] host       graph frequency 'f'
  hapbits  uint32 [M, W] host    one bit per haplotype, W = ceil(nhap/32)
  refflag  bool   [M] host       "k-mer also occurs in the reference genome
                                 but not in this node's REF path"
                                 (src/construct_index.cpp:1211-1215)

Coverage is int32 because torch's uint32 has few operations; counts stay far
below 2^31.  Only keys and cov are read on the device, by the counting join,
so the rest stays host numpy as in the JAX package.

``count_join`` is the plain torch version of the counting join; the CUDA
kernel in ``ops/join_cuda.py`` has the same contract.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

# xor with this maps unsigned 64-bit order onto signed int64 order
_ORDER_FLIP = -(1 << 63)


def count_join(cov: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
               mask: torch.Tensor) -> None:
    """cov[i] += #{j : mask[j] and queries[j] == keys[i]}, in place.

    keys: int64 [M], unique and sorted by unsigned value; queries: int64 [Q];
    mask: bool [Q]; cov: int32 [M].  Plain torch (order-mapped
    ``searchsorted``, then ``index_add_``); the CUDA kernel
    (``ops/join_cuda.count_join_``) is held against it.
    """
    m = keys.numel()
    if m == 0 or queries.numel() == 0:
        return
    kf = keys ^ _ORDER_FLIP
    qf = queries[mask] ^ _ORDER_FLIP
    idx = torch.searchsorted(kf, qf).clamp_(max=m - 1)
    idx = idx[kf[idx] == qf]
    cov.index_add_(0, idx, torch.ones(idx.shape, dtype=cov.dtype,
                                      device=cov.device))


_LITTLE = sys.byteorder == "little"


def pack_hapbits(bitrows: np.ndarray) -> np.ndarray:
    """[M, H] 0/1 matrix -> [M, W] uint32 words (hap i -> word i>>5, bit i&31)."""
    m, h = bitrows.shape
    w = (h + 31) // 32
    if _LITTLE:
        # np.packbits(bitorder="little") puts column 8j+b into bit b of byte
        # j; a little-endian u32 view then maps column 32w+i to bit i of
        # word w -- exactly the layout above, at memcpy-ish speed.
        if h == w * 32 and bitrows.dtype == np.uint8 and bitrows.flags.c_contiguous:
            src = bitrows
        else:
            src = np.zeros((m, w * 32), dtype=np.uint8)
            src[:, :h] = bitrows
        return np.packbits(src, axis=1, bitorder="little").view(np.uint32)
    padded = np.zeros((m, w * 32), dtype=np.uint32)
    padded[:, :h] = bitrows.astype(np.uint32)
    words = padded.reshape(m, w, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (words << shifts).sum(axis=2, dtype=np.uint32)


def unpack_hapbits(words: np.ndarray, nhap: int) -> np.ndarray:
    """[M, W] uint32 -> [M, nhap] uint8 0/1."""
    m, w = words.shape
    if _LITTLE:
        by = np.ascontiguousarray(words).view(np.uint8).reshape(m, w * 4)
        return np.unpackbits(by, axis=1, bitorder="little")[:, :nhap]
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(m, w * 32)[:, :nhap].astype(np.uint8)


def bytes_to_words(packed_bytes: np.ndarray, nhap: int) -> np.ndarray:
    """[M, nbytes] packed-bit uint8 rows (hap i -> byte i>>3, bit i&7, the
    reference's BitVec layout) -> [M, W] uint32 words (hap i -> word i>>5,
    bit i&31).  Pure byte-level reshape on little-endian hosts."""
    m, nb = packed_bytes.shape
    w = (nhap + 31) // 32
    out_b = np.zeros((m, w * 4), np.uint8)
    out_b[:, : min(nb, w * 4)] = packed_bytes[:, : w * 4]
    if _LITTLE:
        return out_b.view(np.uint32)
    words = out_b.reshape(m, w, 4).astype(np.uint32)
    return (
        words[:, :, 0] | (words[:, :, 1] << 8) | (words[:, :, 2] << 16)
        | (words[:, :, 3] << 24)
    )


@dataclass
class KmerTable:
    keys: torch.Tensor     # int64 [M] on device, unsigned-sorted bit patterns
    cov: torch.Tensor      # int32 [M] on device
    freq: np.ndarray       # uint8 [M]
    hapbits: np.ndarray    # uint32 [M, W]
    refflag: np.ndarray    # bool [M]
    nhap: int
    keys_host: np.ndarray  # uint64 [M], the same keys on the host

    @staticmethod
    def from_numpy(keys_u64: np.ndarray, cov: np.ndarray | None,
                   freq: np.ndarray, hap_words: np.ndarray,
                   refflag: np.ndarray, nhap: int,
                   device: torch.device | str) -> "KmerTable":
        """Build from host arrays, such as the JAX package's table views or
        a .vgt's members.  keys_u64 must be unique and sorted (the counting
        join relies on it); cov may be None for a zeroed table."""
        # writable: torch.from_numpy warns on (and would alias) read-only
        keys_u64 = np.require(keys_u64, np.uint64, ["C", "W"])
        if len(keys_u64) > 1 and not np.all(keys_u64[1:] > keys_u64[:-1]):
            raise ValueError("table keys must be unique and sorted")
        m = len(keys_u64)
        if cov is None:
            cov_t = torch.zeros(m, dtype=torch.int32, device=device)
        else:
            if len(cov) != m:
                raise ValueError(f"cov has {len(cov)} rows for {m} keys")
            cov_t = torch.from_numpy(
                np.asarray(cov).astype(np.int32)).to(device)
        return KmerTable(
            keys=torch.from_numpy(keys_u64.view(np.int64)).to(device),
            cov=cov_t,
            freq=np.ascontiguousarray(freq, dtype=np.uint8),
            hapbits=np.ascontiguousarray(hap_words, dtype=np.uint32),
            refflag=np.ascontiguousarray(refflag, dtype=np.bool_),
            nhap=nhap,
            keys_host=keys_u64,
        )

    @staticmethod
    def build_packed(keys: np.ndarray, freq: np.ndarray,
                     hapbit_bytes: np.ndarray, refflag: np.ndarray, nhap: int,
                     device: torch.device | str) -> "KmerTable":
        """Build from host arrays with bit-packed haplotype rows
        ([M, ceil(nhap/8)] uint8, hap i -> byte i>>3 bit i&7), as
        index/build.index_graph emits them.  Never materializes the
        [M, nhap] matrix.  Sorts on the host when the keys are not sorted
        (index_graph emits them sorted, so that is skipped); keys and cov go
        to ``device``, the rest stays host numpy."""
        keys = np.asarray(keys, np.uint64)
        if len(keys) > 1 and not np.all(keys[1:] > keys[:-1]):
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            freq, hapbit_bytes, refflag = (
                freq[order], hapbit_bytes[order], refflag[order]
            )
        return KmerTable.from_numpy(keys, None, freq,
                                    bytes_to_words(hapbit_bytes, nhap),
                                    refflag, nhap, device)

    @property
    def size(self) -> int:
        return int(self.keys.shape[0])

    @property
    def device(self) -> torch.device:
        return self.cov.device

    def cov_u8(self) -> np.ndarray:
        """Coverage saturated to uint8, the reference's 'c'."""
        return self.cov.clamp(max=255).to(torch.uint8).cpu().numpy()

    def reset_cov(self) -> None:
        """Zero coverage between samples (reference ConstructIndex::reset,
        include/construct_index.hpp:317-331), in place."""
        self.cov.zero_()

    # host views, under the JAX package's names
    def keys_np(self) -> np.ndarray:
        return self.keys_host

    def freq_np(self) -> np.ndarray:
        return self.freq

    def hap_words_np(self) -> np.ndarray:
        """Packed [M, W] uint32 haplotype bits."""
        return self.hapbits

    def hapbit_rows_np(self) -> np.ndarray:
        """Unpacked [M, nhap] matrix -- tests only; at genome scale this is
        tens of GB."""
        return unpack_hapbits(self.hapbits, self.nhap)

    def refflag_np(self) -> np.ndarray:
        return self.refflag
