"""Wrapper of the CUDA counting join (``csrc/join.cu``).

``count_join_(cov, keys, queries, mask)`` adds to ``cov`` in place:
cov[i] += #{j : mask[j] and queries[j] == keys[i]}.  It replaces the Pallas
banded merge-join of ``varigraph_tpu/ops/join_pallas.py`` and, for large
tables, ``count_merge_super`` of ``varigraph_tpu/ops/table.py``.

On CPU tensors it runs the plain torch version, ``ops.table.count_join``.  On
CUDA tensors it launches the kernel or raises: a failed build or launch is an
error, never a quiet fall back to plain code.

The kernel is compiled from the repository's source with ``nvcc`` at first
use (``ops/cuda_build.py``).  ``LAUNCHES["count_join"]`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary
from .table import count_join


def _declare(lib: ctypes.CDLL) -> None:
    lib.vg_count_join.restype = ctypes.c_int
    lib.vg_count_join.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
    ]


_LIB = KernelLibrary("join.cu", "libvgjoin.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the join library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check(cov, keys, queries, mask) -> None:
    for name, t, dt in (("cov", cov, torch.int32), ("keys", keys, torch.int64),
                        ("queries", queries, torch.int64),
                        ("mask", mask, torch.bool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != cov.device:
            raise ValueError(f"{name} is on {t.device}, cov on {cov.device}")
    if cov.shape != keys.shape:
        raise ValueError(f"cov {tuple(cov.shape)} and keys {tuple(keys.shape)} differ")
    if mask.shape != queries.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and queries "
                         f"{tuple(queries.shape)} differ")


def count_join_(cov: torch.Tensor, keys: torch.Tensor, queries: torch.Tensor,
                mask: torch.Tensor) -> None:
    """cov[i] += #{j : mask[j] and queries[j] == keys[i]}, in place.

    cov int32 [M]; keys int64 [M], unique and sorted by unsigned value;
    queries int64 [Q]; mask bool [Q]; all contiguous, on one device."""
    _check(cov, keys, queries, mask)
    if cov.device.type == "cpu":
        count_join(cov, keys, queries, mask)
        return
    if cov.device.type != "cuda":
        raise ValueError(f"count_join_ runs on cpu or cuda, not {cov.device}")
    m, nq = keys.numel(), queries.numel()
    if m == 0 or nq == 0:
        return
    lib = build()
    with torch.cuda.device(cov.device):
        stream = torch.cuda.current_stream(cov.device).cuda_stream
        rc = lib.vg_count_join(cov.data_ptr(), keys.data_ptr(), m,
                               queries.data_ptr(), mask.data_ptr(), nq, stream)
    if rc != 0:
        raise RuntimeError(f"count_join kernel launch failed: CUDA error {rc}")
    LAUNCHES["count_join"] += 1
