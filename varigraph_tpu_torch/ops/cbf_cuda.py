"""Wrapper of the CUDA counting Bloom filter (``csrc/cbf.cu``).

``cbf_add_(filter, keys, mask, seeds, m, lo)`` adds one, saturating at 255,
at each of the kh positions of every key whose mask is set, in place.
``cbf_add_codes_(filter, codes, k, seeds, m, lo)`` does the same for every
k-mer that a chromosome's base codes emit, cut into genome rows as
``ops/cbf.genome_rows`` says, without writing the k-mers anywhere: it is
construct's genome count.  ``cbf_count(filter, keys, seeds, m, lo)`` returns
each key's minimum counter.  ``filter`` holds the cells
[lo, lo + filter.numel()) of a filter of m cells: a shard of a
``ShardedCBF``, or by default (m = filter.numel(), lo = 0) the whole filter;
positions outside the shard are skipped, and a key with none in it counts
255.  They replace the XLA functions ``_positions``, ``_add`` and ``_count``
of ``varigraph_tpu/ops/cbf.py``, the per-shard bodies of
``make_cbf_add_sharded`` and ``make_cbf_count_sharded``
(``varigraph_tpu/parallel/mesh.py:205-283``) and, in the genome count, the
``sketch_codes`` that feeds the add.

On CPU tensors they run the plain torch versions (``ops/cbf.py``).  On CUDA
tensors they launch the kernels or raise: a failed build or launch is an
error, never a quiet fall back to plain code.  ``LAUNCHES["cbf_add"]``,
``LAUNCHES["cbf_add_codes"]`` and ``LAUNCHES["cbf_count"]`` count kernel
launches, one for each call of the kernel's entry (an add is one call for
every STAGE_POSITIONS positions or fewer).

Arguments: filter uint8 [m_local], m_local >= 1, 0 <= lo and
lo + m_local <= m; on CUDA it is 4-byte aligned and its storage extends to
a whole number of 32-bit words (the kernel updates a byte through its word);
keys int64 [N] (uint64 bit patterns); mask bool [N]; codes uint8 [n] (0..3,
4 = ambiguous); 1 <= k <= 28; seeds int64 [kh], 1 <= kh <= 16 (uint64 bit
patterns, only their low 32 bits are used); all contiguous, on one device.
Positions are a mask when m is a power of two and an unsigned modulo
otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from .cbf import (GENOME_COLS, MAX_SEEDS, cbf_add_codes_plain, cbf_add_plain,
                  cbf_count_plain, genome_rows)
from .cuda_build import LAUNCHES, KernelLibrary

# The most positions one call of an add stages: its two entries buffers hold
# 4 bytes a position each, 2 GiB at this size.
STAGE_POSITIONS = 1 << 28


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_cbf_counter_words.restype = n
    lib.vg_cbf_counter_words.argtypes = [n]
    lib.vg_cbf_add.restype = i
    lib.vg_cbf_add.argtypes = [p, n, n, n, p, p, n, p, i, p, p, n, p]
    lib.vg_cbf_add_codes.restype = i
    lib.vg_cbf_add_codes.argtypes = [p, n, n, n, p, n, n, n, i, p, i, p, p, n, p]
    lib.vg_cbf_count.restype = i
    lib.vg_cbf_count.argtypes = [p, p, n, n, n, p, n, p, i, p]


_LIB = KernelLibrary("cbf.cu", "libvgcbf.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the filter library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check(filter, seeds, m: int, lo: int, **tensors) -> None:
    """Checks the filter, the seeds and each of ``tensors`` (name ->
    (tensor, dtype))."""
    args = [("filter", filter, torch.uint8), ("seeds", seeds, torch.int64)]
    args += [(name, t, dt) for name, (t, dt) in tensors.items()]
    for name, t, dt in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != filter.device:
            raise ValueError(f"{name} is on {t.device}, filter on {filter.device}")
    m_local = filter.numel()
    if (m_local < 1 or lo < 0 or lo + m_local > m or m >= 1 << 62
            or m_local > 1 << 39):
        raise ValueError(f"the filter's {m_local} cells from {lo} are not a "
                         f"shard of a filter of {m} cells")
    if not 1 <= seeds.numel() <= MAX_SEEDS:
        raise ValueError(f"the kernels take 1 to {MAX_SEEDS} hash seeds (kh), "
                         f"got {seeds.numel()}")
    if filter.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the filter runs on cpu or cuda, not {filter.device}")
    if filter.device.type == "cuda":
        if filter.data_ptr() % 4:
            raise ValueError("filter must be 4-byte aligned")
        room = filter.untyped_storage().nbytes() - filter.storage_offset()
        if room < -(-m_local // 4) * 4:
            raise ValueError("the filter's storage must extend to a whole "
                             "number of 32-bit words")


def _stage(filter, name: str, launch, items: int, per_item: int) -> None:
    """Calls ``launch(lib, first, count, counters, entries, capacity,
    stream)`` for consecutive runs of items of at most STAGE_POSITIONS
    positions (per_item at most a item), with the scratch the kernel needs;
    raises on a refused launch."""
    lib = build()
    dev = filter.device
    chunk = max(1, STAGE_POSITIONS // per_item)
    capacity = min(chunk, items) * per_item
    with torch.cuda.device(dev):
        counters = torch.empty(lib.vg_cbf_counter_words(filter.numel()),
                               dtype=torch.int32, device=dev)
        entries = torch.empty(2 * capacity, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, items, chunk):
            rc = launch(lib, first, min(chunk, items - first),
                        counters.data_ptr(), entries.data_ptr(), capacity,
                        stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
            LAUNCHES[name] += 1


def cbf_add_(filter: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
             seeds: torch.Tensor, m: int | None = None, lo: int = 0) -> None:
    """filter[p - lo] = min(filter[p - lo] + 1, 255) at every position p in
    [lo, lo + filter.numel()) of every key whose mask is set, in place."""
    m = filter.numel() if m is None else int(m)
    _check(filter, seeds, m, lo, keys=(keys, torch.int64), mask=(mask, torch.bool))
    if mask.shape != keys.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and keys "
                         f"{tuple(keys.shape)} differ")
    if filter.device.type == "cpu":
        cbf_add_plain(filter, keys, mask, seeds, m, lo)
        return
    kh = seeds.numel()
    _stage(filter, "cbf_add", lambda lib, j, n, *scratch:
           lib.vg_cbf_add(filter.data_ptr(), m, lo, filter.numel(),
                          keys.data_ptr() + 8 * j, mask.data_ptr() + j, n,
                          seeds.data_ptr(), kh, *scratch),
           keys.numel(), kh)


def cbf_add_codes_(filter: torch.Tensor, codes: torch.Tensor, k: int,
                   seeds: torch.Tensor, m: int | None = None,
                   lo: int = 0) -> None:
    """The saturating add of every k-mer that the genome rows of a
    chromosome's base codes emit (``ops/cbf.cbf_add_codes_plain``), at its
    positions in [lo, lo + filter.numel()), in place."""
    m = filter.numel() if m is None else int(m)
    _check(filter, seeds, m, lo, codes=(codes, torch.uint8))
    if not 0 < k <= 28:
        raise ValueError(f"k must be in 1..28, got {k}")
    if filter.device.type == "cpu":
        cbf_add_codes_plain(filter, codes, k, seeds, m, lo)
        return
    kh = seeds.numel()
    _stage(filter, "cbf_add_codes", lambda lib, r0, n, *scratch:
           lib.vg_cbf_add_codes(filter.data_ptr(), m, lo, filter.numel(),
                                codes.data_ptr(), codes.numel(), r0, n, k,
                                seeds.data_ptr(), kh, *scratch),
           genome_rows(codes.numel(), k), (GENOME_COLS - k + 1) * kh)


def cbf_count(filter: torch.Tensor, keys: torch.Tensor, seeds: torch.Tensor,
              m: int | None = None, lo: int = 0) -> torch.Tensor:
    """uint8 [N]: each key's minimum counter over its positions in
    [lo, lo + filter.numel()), 255 where it has none there."""
    m = filter.numel() if m is None else int(m)
    _check(filter, seeds, m, lo, keys=(keys, torch.int64))
    if filter.device.type == "cpu":
        return cbf_count_plain(filter, keys, seeds, m, lo)
    n = keys.numel()
    out = torch.empty(n, dtype=torch.uint8, device=filter.device)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(filter.device):
        stream = torch.cuda.current_stream(filter.device).cuda_stream
        rc = lib.vg_cbf_count(out.data_ptr(), filter.data_ptr(), m, lo,
                              filter.numel(), keys.data_ptr(), n,
                              seeds.data_ptr(), seeds.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"cbf_count kernel launch failed: CUDA error {rc}")
    LAUNCHES["cbf_count"] += 1
    return out
