"""Wrappers of construct's sketch kernels (``csrc/sketch.cu``).

``count_codes_(cov, keys, directory, codes, k)`` adds to ``cov`` in place the
exact genome count of one chromosome's base codes: every window that its
genome rows (``ops/cbf.genome_rows``) emit, looked up through the keys'
directory (``ops/table.key_directory``).  It replaces
``_count_codes_stack`` (``varigraph_tpu/ops/exact_count.py:44``): the XLA
``sketch_codes`` and the join behind it, in one kernel that writes nothing
but cov.

``sketch_contexts(codes, offsets, k)`` returns each context's unique k-mer
values in unsigned order as a CSR ``(values, starts)``: the sketch of
``sketch_codes`` as ``_sketch_contexts`` (``varigraph_tpu/index/build.py:162``)
uses it, for contexts of any length, unpadded.  A count pass, a scan into
write offsets, a values pass, then the sorts and the compaction of
``ops/sketch.dedup_contexts`` on the card.

On CPU tensors each wrapper runs its plain torch version
(``ops/sketch.count_codes_plain``, ``ops/sketch.sketch_contexts_plain``).  On
CUDA tensors it launches the kernels or raises: a failed build or launch is
an error, never a quiet fall back to plain code.  ``LAUNCHES["count_codes"]``
counts the exact count's kernel launches (one a chromosome of up to
STAGE_POSITIONS positions); ``LAUNCHES["sketch_contexts"]`` counts the
context sketch's calls (each launches its two passes).
"""

from __future__ import annotations

import ctypes

import torch

from .cbf import GENOME_COLS, genome_rows
from .cbf_cuda import STAGE_POSITIONS
from .cuda_build import LAUNCHES, KernelLibrary
from .join_cuda import _check_table, _check_tensor
from .sketch import count_codes_plain, dedup_contexts, sketch_contexts_plain


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_count_codes.restype = i
    lib.vg_count_codes.argtypes = [p, p, n, p, i, p, n, n, n, i, p]
    lib.vg_context_counts.restype = i
    lib.vg_context_counts.argtypes = [p, p, n, i, p, p]
    lib.vg_context_values.restype = i
    lib.vg_context_values.argtypes = [p, p, n, i, p, p, p]


_LIB = KernelLibrary("sketch.cu", "libvgsketch.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the sketch library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check_k(k: int) -> None:
    if not 0 < k <= 28:
        raise ValueError(f"k must be in 1..28, got {k}")


def _run(name: str, device: torch.device, call) -> None:
    """Runs ``call(lib, stream)`` on device's card; raises on a refused
    launch."""
    lib = build()
    with torch.cuda.device(device):
        rc = call(lib, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def count_codes_(cov: torch.Tensor, keys: torch.Tensor, directory: torch.Tensor,
                 codes: torch.Tensor, k: int) -> None:
    """cov[i] += the windows of a chromosome's genome rows whose value is
    keys[i], in place.

    cov int32 [M]; keys int64 [M], unique and sorted by unsigned value;
    directory int32 [2^bits + 1], the keys' ``key_directory``; codes uint8
    [n], the chromosome's base codes (0..3, 4 = ambiguous); all contiguous,
    on one device; 1 <= k <= 28.  The count is not capped."""
    bits = _check_table(cov, keys, directory)
    _check_tensor("codes", codes, torch.uint8, 1, cov.device)
    _check_k(k)
    if cov.device.type == "cpu":
        count_codes_plain(cov, keys, codes, k)
        return
    if cov.device.type != "cuda":
        raise ValueError(f"count_codes_ runs on cpu or cuda, not {cov.device}")
    m, rows = keys.numel(), genome_rows(codes.numel(), k)
    if m == 0:
        return
    # a chromosome a launch up to the fused add's STAGE_POSITIONS positions
    chunk = max(1, STAGE_POSITIONS // (GENOME_COLS - k + 1))
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        _run("count_codes", cov.device, lambda lib, stream: lib.vg_count_codes(
            cov.data_ptr(), keys.data_ptr(), m, directory.data_ptr(), bits,
            codes.data_ptr(), codes.numel(), r0, n, k, stream))
        LAUNCHES["count_codes"] += 1


def _check_contexts(codes, offsets) -> None:
    for name, t, dt in (("codes", codes, torch.uint8),
                        ("offsets", offsets, torch.int64)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if offsets.device != codes.device:
        raise ValueError(f"offsets is on {offsets.device}, codes on {codes.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sketch_contexts runs on cpu or cuda, not {codes.device}")
    if offsets.numel() < 1:
        raise ValueError("offsets must hold at least one entry (C + 1)")
    if bool((offsets[0] != 0) | (offsets[-1] > codes.numel())
            | (offsets[1:] < offsets[:-1]).any()):
        raise ValueError("offsets must start at 0, never decrease and end "
                         "within codes")


def sketch_contexts(codes: torch.Tensor, offsets: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values int64, starts int64 [C + 1]) on codes' device: context c's
    unique k-mer values, in unsigned order, are values[starts[c]:starts[c +
    1]].

    codes uint8 [T], the contexts one after another (0..3, 4 = ambiguous);
    offsets int64 [C + 1], context c is codes[offsets[c]:offsets[c + 1]],
    offsets[0] = 0; both contiguous, on one device; 1 <= k <= 28."""
    _check_contexts(codes, offsets)
    _check_k(k)
    if codes.device.type == "cpu":
        return sketch_contexts_plain(codes, offsets, k)
    dev, n_ctx = codes.device, offsets.numel() - 1
    counts = torch.empty(n_ctx, dtype=torch.int64, device=dev)
    _run("sketch_contexts", dev, lambda lib, stream: lib.vg_context_counts(
        codes.data_ptr(), offsets.data_ptr(), n_ctx, k, counts.data_ptr(),
        stream))
    ends = torch.cumsum(counts, 0)
    values = torch.empty(int(ends[-1]) if n_ctx else 0, dtype=torch.int64,
                         device=dev)
    starts = ends - counts
    _run("sketch_contexts", dev, lambda lib, stream: lib.vg_context_values(
        codes.data_ptr(), offsets.data_ptr(), n_ctx, k, starts.data_ptr(),
        values.data_ptr(), stream))
    LAUNCHES["sketch_contexts"] += 1
    return dedup_contexts(values, counts)
