"""Wrapper of the CUDA counting Bloom filter (``csrc/cbf.cu``).

``cbf_add_(filter, keys, mask, seeds, m, lo)`` adds one, saturating at 255,
at each of the kh positions of every key whose mask is set, in place.
``cbf_count(filter, keys, seeds, m, lo)`` returns each key's minimum counter.
``filter`` holds the cells [lo, lo + filter.numel()) of a filter of m cells:
a shard of a ``ShardedCBF``, or by default (m = filter.numel(), lo = 0) the
whole filter; positions outside the shard are skipped, and a key with none in
it counts 255.  They replace the XLA functions ``_positions``, ``_add`` and
``_count`` of ``varigraph_tpu/ops/cbf.py`` and the per-shard bodies of
``make_cbf_add_sharded`` and ``make_cbf_count_sharded``
(``varigraph_tpu/parallel/mesh.py:205-283``).

On CPU tensors they run the plain torch versions (``ops/cbf.py``).  On CUDA
tensors they launch the kernels or raise: a failed build or launch is an
error, never a quiet fall back to plain code.  ``LAUNCHES["cbf_add"]`` and
``LAUNCHES["cbf_count"]`` count kernel launches.

Arguments: filter uint8 [m_local], m_local >= 1, 0 <= lo and
lo + m_local <= m; on CUDA it is 4-byte aligned and its storage extends to
a whole number of 32-bit words (the kernel updates a byte through its word);
keys int64 [N] (uint64 bit patterns); mask bool [N]; seeds int64 [kh]
(uint64 bit patterns, only their low 32 bits are used); all contiguous, on
one device.  Positions are a mask when m is a power of two and an unsigned
modulo otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from .cbf import cbf_add_plain, cbf_count_plain
from .cuda_build import LAUNCHES, KernelLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.vg_cbf_add.restype = ctypes.c_int
    lib.vg_cbf_add.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.vg_cbf_count.restype = ctypes.c_int
    lib.vg_cbf_count.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]


_LIB = KernelLibrary("cbf.cu", "libvgcbf.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the filter library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check(filter, keys, seeds, mask, m: int, lo: int) -> None:
    args = [("filter", filter, torch.uint8), ("keys", keys, torch.int64),
            ("seeds", seeds, torch.int64)]
    if mask is not None:
        args.append(("mask", mask, torch.bool))
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
    if m_local < 1 or lo < 0 or lo + m_local > m or m >= 1 << 62:
        raise ValueError(f"the filter's {m_local} cells from {lo} are not a "
                         f"shard of a filter of {m} cells")
    if seeds.numel() < 1:
        raise ValueError("at least one hash seed is needed")
    if mask is not None and mask.shape != keys.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and keys "
                         f"{tuple(keys.shape)} differ")
    if filter.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the filter runs on cpu or cuda, not {filter.device}")
    if filter.device.type == "cuda":
        if filter.data_ptr() % 4:
            raise ValueError("filter must be 4-byte aligned")
        room = filter.untyped_storage().nbytes() - filter.storage_offset()
        if room < -(-m_local // 4) * 4:
            raise ValueError("the filter's storage must extend to a whole "
                             "number of 32-bit words")


def cbf_add_(filter: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
             seeds: torch.Tensor, m: int | None = None, lo: int = 0) -> None:
    """filter[p - lo] = min(filter[p - lo] + 1, 255) at every position p in
    [lo, lo + filter.numel()) of every key whose mask is set, in place."""
    m = filter.numel() if m is None else int(m)
    _check(filter, keys, seeds, mask, m, lo)
    if filter.device.type == "cpu":
        cbf_add_plain(filter, keys, mask, seeds, m, lo)
        return
    n = keys.numel()
    if n == 0:
        return
    lib = build()
    with torch.cuda.device(filter.device):
        stream = torch.cuda.current_stream(filter.device).cuda_stream
        rc = lib.vg_cbf_add(filter.data_ptr(), m, lo, filter.numel(),
                            keys.data_ptr(), mask.data_ptr(), n,
                            seeds.data_ptr(), seeds.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"cbf_add kernel launch failed: CUDA error {rc}")
    LAUNCHES["cbf_add"] += 1


def cbf_count(filter: torch.Tensor, keys: torch.Tensor, seeds: torch.Tensor,
              m: int | None = None, lo: int = 0) -> torch.Tensor:
    """uint8 [N]: each key's minimum counter over its positions in
    [lo, lo + filter.numel()), 255 where it has none there."""
    m = filter.numel() if m is None else int(m)
    _check(filter, keys, seeds, None, m, lo)
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
