"""Wrapper of the CUDA counting Bloom filter (``csrc/cbf.cu``).

``cbf_add_(filter, keys, mask, seeds)`` adds one, saturating at 255, at each
of the kh positions of every key whose mask is set, in place.
``cbf_count(filter, keys, seeds)`` returns each key's minimum counter.  They
replace the XLA functions ``_positions``, ``_add`` and ``_count`` of
``varigraph_tpu/ops/cbf.py``.

On CPU tensors they run the plain torch versions (``ops/cbf.py``).  On CUDA
tensors they launch the kernels or raise: a failed build or launch is an
error, never a quiet fall back to plain code.  ``LAUNCHES["cbf_add"]`` and
``LAUNCHES["cbf_count"]`` count kernel launches.

Arguments: filter uint8 [m], m a power of two >= 4; keys int64 [N] (uint64
bit patterns); mask bool [N]; seeds int64 [kh] (uint64 bit patterns, only
their low 32 bits are used); all contiguous, on one device.
"""

from __future__ import annotations

import ctypes

import torch

from .cbf import cbf_add_plain, cbf_count_plain
from .cuda_build import LAUNCHES, KernelLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.vg_cbf_add.restype = ctypes.c_int
    lib.vg_cbf_add.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.vg_cbf_count.restype = ctypes.c_int
    lib.vg_cbf_count.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]


_LIB = KernelLibrary("cbf.cu", "libvgcbf.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the filter library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check(filter, keys, seeds, mask=None) -> None:
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
    m = filter.numel()
    if m < 4 or m & (m - 1):
        raise ValueError(f"filter size must be a power of two >= 4, got {m}")
    if seeds.numel() < 1:
        raise ValueError("at least one hash seed is needed")
    if mask is not None and mask.shape != keys.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and keys "
                         f"{tuple(keys.shape)} differ")
    if filter.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the filter runs on cpu or cuda, not {filter.device}")
    if filter.device.type == "cuda" and filter.data_ptr() % 4:
        raise ValueError("filter must be 4-byte aligned")


def cbf_add_(filter: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
             seeds: torch.Tensor) -> None:
    """filter[p] = min(filter[p] + 1, 255) at every position p of every key
    whose mask is set, in place."""
    _check(filter, keys, seeds, mask)
    if filter.device.type == "cpu":
        cbf_add_plain(filter, keys, mask, seeds)
        return
    n = keys.numel()
    if n == 0:
        return
    lib = build()
    with torch.cuda.device(filter.device):
        stream = torch.cuda.current_stream(filter.device).cuda_stream
        rc = lib.vg_cbf_add(filter.data_ptr(), filter.numel(), keys.data_ptr(),
                            mask.data_ptr(), n, seeds.data_ptr(), seeds.numel(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"cbf_add kernel launch failed: CUDA error {rc}")
    LAUNCHES["cbf_add"] += 1


def cbf_count(filter: torch.Tensor, keys: torch.Tensor,
              seeds: torch.Tensor) -> torch.Tensor:
    """uint8 [N]: each key's minimum counter over its kh positions."""
    _check(filter, keys, seeds)
    if filter.device.type == "cpu":
        return cbf_count_plain(filter, keys, seeds)
    n = keys.numel()
    out = torch.empty(n, dtype=torch.uint8, device=filter.device)
    if n == 0:
        return out
    lib = build()
    with torch.cuda.device(filter.device):
        stream = torch.cuda.current_stream(filter.device).cuda_stream
        rc = lib.vg_cbf_count(out.data_ptr(), filter.data_ptr(), filter.numel(),
                              keys.data_ptr(), n, seeds.data_ptr(),
                              seeds.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"cbf_count kernel launch failed: CUDA error {rc}")
    LAUNCHES["cbf_count"] += 1
    return out
