"""Wrappers of the CUDA counting kernels (``csrc/join.cu``).

``count_join_(cov, keys, directory, queries, mask)`` adds to ``cov`` in
place: cov[i] += #{j : mask[j] and queries[j] == keys[i]}.  It replaces the
Pallas banded merge-join of ``varigraph_tpu/ops/join_pallas.py`` and the
two-sort joins ``count_merge`` and ``count_merge_super`` of
``varigraph_tpu/ops/table.py``.  No main path launches it: construct's exact
genome count sketches and looks up in one kernel
(``ops/sketch_cuda.count_codes_``).

``count_packed_(cov, keys, directory, packed, k)`` adds the canonical k-mers
of a packed read batch (``ops/kmer.unpack_2bit``'s format) to ``cov`` in
place: the sketch and the join in one kernel, which replaces the XLA
``sketch_codes``/``unpack_2bit`` of ``varigraph_tpu/ops/kmer.py`` and the join
behind them on the read path.

``directory`` is the table's key directory (``ops/table.key_directory``,
``KmerTable.directory()``), through which both kernels find a key's bucket.

On CPU tensors each wrapper runs its plain torch version,
``ops.table.count_join`` or ``ops.table.count_packed``, which need no
directory.  On CUDA tensors it launches the kernel or raises: a failed build
or launch is an error, never a quiet fall back to plain code.

The kernels are compiled from the repository's source with ``nvcc`` at first
use (``ops/cuda_build.py``).  ``LAUNCHES["count_join"]`` and
``LAUNCHES["count_packed"]`` count kernel launches, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary
from .table import count_join, count_packed


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_count_join.restype = ctypes.c_int
    lib.vg_count_join.argtypes = [p, p, n, p, i, p, p, n, p]
    lib.vg_count_packed.restype = ctypes.c_int
    lib.vg_count_packed.argtypes = [p, p, n, p, i, p, n, n, i, p]


_LIB = KernelLibrary("join.cu", "libvgjoin.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the join library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check_tensor(name: str, t, dtype: torch.dtype, dim: int,
                  device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, cov on {device}")


def _check_table(cov, keys, directory) -> int:
    """Checks cov, keys and the directory; returns the directory's bits."""
    _check_tensor("cov", cov, torch.int32, 1, cov.device)
    _check_tensor("keys", keys, torch.int64, 1, cov.device)
    _check_tensor("directory", directory, torch.int32, 1, cov.device)
    if cov.shape != keys.shape:
        raise ValueError(f"cov {tuple(cov.shape)} and keys {tuple(keys.shape)} differ")
    if keys.numel() >= 1 << 31:
        raise ValueError(f"a directory indexes fewer than 2^31 keys, got "
                         f"{keys.numel()}")
    nb = directory.numel() - 1
    if nb < 2 or nb & (nb - 1):
        raise ValueError(f"directory must hold 2^bits + 1 entries, bits >= 1; "
                         f"got {directory.numel()}")
    return nb.bit_length() - 1


def _launch(name: str, cov: torch.Tensor, call) -> None:
    """Runs ``call(lib, stream)`` on cov's card and counts the launch; raises
    on a refused launch."""
    if cov.device.type != "cuda":
        raise ValueError(f"{name}_ runs on cpu or cuda, not {cov.device}")
    lib = build()
    with torch.cuda.device(cov.device):
        rc = call(lib, torch.cuda.current_stream(cov.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def count_join_(cov: torch.Tensor, keys: torch.Tensor, directory: torch.Tensor,
                queries: torch.Tensor, mask: torch.Tensor) -> None:
    """cov[i] += #{j : mask[j] and queries[j] == keys[i]}, in place.

    cov int32 [M]; keys int64 [M], unique and sorted by unsigned value;
    directory int32 [2^bits + 1], the keys' ``key_directory``; queries int64
    [Q]; mask bool [Q]; all contiguous, on one device."""
    bits = _check_table(cov, keys, directory)
    _check_tensor("queries", queries, torch.int64, 1, cov.device)
    _check_tensor("mask", mask, torch.bool, 1, cov.device)
    if mask.shape != queries.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and queries "
                         f"{tuple(queries.shape)} differ")
    if cov.device.type == "cpu":
        count_join(cov, keys, queries, mask)
        return
    m, nq = keys.numel(), queries.numel()
    if m == 0 or nq == 0:
        return
    _launch("count_join", cov, lambda lib, stream: lib.vg_count_join(
        cov.data_ptr(), keys.data_ptr(), m, directory.data_ptr(), bits,
        queries.data_ptr(), mask.data_ptr(), nq, stream))


def count_packed_(cov: torch.Tensor, keys: torch.Tensor, directory: torch.Tensor,
                  packed: torch.Tensor, k: int) -> None:
    """cov[i] += the number of windows of the packed reads whose canonical
    k-mer encodes to keys[i], in place.

    cov, keys, directory as for ``count_join_``; packed uint8 [B, L/4 + 2],
    contiguous, on cov's device (rows of 2-bit bases and a u16-LE length,
    ``ops/kmer.unpack_2bit``); 1 <= k <= 28."""
    bits = _check_table(cov, keys, directory)
    _check_tensor("packed", packed, torch.uint8, 2, cov.device)
    if packed.shape[1] < 2:
        raise ValueError(f"packed rows end in a 2-byte length; got "
                         f"{packed.shape[1]} bytes a row")
    if not 0 < k <= 28:
        raise ValueError(f"k must be in 1..28, got {k}")
    if cov.device.type == "cpu":
        count_packed(cov, keys, packed, k)
        return
    m, nrows = keys.numel(), packed.shape[0]
    if m == 0 or nrows == 0:
        return
    _launch("count_packed", cov, lambda lib, stream: lib.vg_count_packed(
        cov.data_ptr(), keys.data_ptr(), m, directory.data_ptr(), bits,
        packed.data_ptr(), nrows, packed.shape[1], k, stream))
