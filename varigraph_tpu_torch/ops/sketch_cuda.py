"""Wrappers of construct's sketch kernels (``csrc/sketch.cu``).

``count_codes_(cov, keys, directory, bitmap, codes, k)`` adds to ``cov`` in
place the exact genome count of one chromosome's base codes: every window
that its genome rows (``ops/cbf.genome_rows``) emit, looked up through the
keys' directory (``ops/table.key_directory``).  It replaces
``_count_codes_stack`` (``varigraph_tpu/ops/exact_count.py:44``): the XLA
``sketch_codes`` and the join behind it, in one kernel that stages a CTA's
rows in shared memory, tests each window in the keys' occupancy bitmap
(``key_bitmap``, built once a table beside the directory), batches each
thread's lookups and writes nothing but cov.

``sketch_contexts(codes, offsets, k)`` returns each context's unique k-mer
values in unsigned order as a CSR ``(values, starts)``: the sketch of
``sketch_codes`` as ``_sketch_contexts`` (``varigraph_tpu/index/build.py:162``)
uses it, for contexts of any length, unpadded.  A context of at most
CONTEXT_TILE windows is sketched, sorted and deduplicated by one warp in
shared memory (the short route, one launch for all of them), its uniques
written at its own offset; a longer one takes the long route, chosen by
length: the count and values passes, then ``ops/sketch.dedup_contexts``'s
torch sorts over those contexts' values alone.  A scan of the unique counts
and a compaction kernel then build the CSR.  The short route's kernel also
checks the offsets and counts the long contexts, so a call reads the card
once (the offsets' check, the long count and the CSR's size together), and
once more where a context takes the long route.

On CPU tensors each wrapper runs its plain torch version
(``ops/sketch.count_codes_plain``, ``ops/sketch.sketch_contexts_plain``).  On
CUDA tensors it launches the kernels or raises: a failed build or launch is
an error, never a quiet fall back to plain code.  ``LAUNCHES["count_codes"]``
counts the exact count's kernel launches (one a chromosome of up to
STAGE_POSITIONS positions), ``LAUNCHES["key_bitmap"]`` the bitmap's (one a
table); ``LAUNCHES["sketch_contexts"]`` counts the
context sketch's calls on the card (each launches the short route and the
compaction, and the long route's two passes where a context takes it).
``LONG_ROUTE["contexts"]`` counts the contexts that took the long route.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .cbf import GENOME_COLS, genome_rows
from .cbf_cuda import STAGE_POSITIONS
from .cuda_build import LAUNCHES, KernelLibrary
from .join_cuda import _check_table, _check_tensor
from .sketch import (count_codes_plain, dedup_contexts, key_bitmap_plain,
                     sketch_contexts_plain)

# windows a warp's tile holds on the short route (csrc/sketch.cu kCtxTile)
CONTEXT_TILE = 512

# contexts that took the long route, by the card's calls
LONG_ROUTE: collections.Counter = collections.Counter()


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_key_bitmap.restype = i
    lib.vg_key_bitmap.argtypes = [p, n, i, p, p]
    lib.vg_count_codes.restype = i
    lib.vg_count_codes.argtypes = [p, p, n, p, i, p, i, p, n, n, n, i, p]
    lib.vg_context_short.restype = i
    lib.vg_context_short.argtypes = [p, n, p, n, i, i, p, p, p, p]
    lib.vg_context_counts.restype = i
    lib.vg_context_counts.argtypes = [p, p, p, n, i, p, p]
    lib.vg_context_values.restype = i
    lib.vg_context_values.argtypes = [p, p, p, n, i, p, p, p]
    lib.vg_context_compact.restype = i
    lib.vg_context_compact.argtypes = [p, p, p, n, p, p]


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


def key_bitmap(keys: torch.Tensor, bbits: int) -> torch.Tensor:
    """The keys' occupancy bitmap, int32 [2^bbits / 32] on their device: bit
    q (word q >> 5, bit q & 31) is set where a key has q as its top bbits
    bits below the largest key's highest (``key_bitmap_plain``).

    keys int64 [M], unique and sorted by unsigned value, contiguous;
    5 <= bbits <= 62."""
    _check_tensor("keys", keys, torch.int64, 1, keys.device)
    if not 5 <= bbits <= 62:
        raise ValueError(f"bitmap bits must be in 5..62, got {bbits}")
    if keys.device.type == "cpu":
        return key_bitmap_plain(keys, bbits)
    if keys.device.type != "cuda":
        raise ValueError(f"key_bitmap runs on cpu or cuda, not {keys.device}")
    words = torch.zeros(1 << (bbits - 5), dtype=torch.int32, device=keys.device)
    if keys.numel():
        _run("key_bitmap", keys.device, lambda lib, stream: lib.vg_key_bitmap(
            keys.data_ptr(), keys.numel(), bbits, words.data_ptr(), stream))
        LAUNCHES["key_bitmap"] += 1
    return words


def _bitmap_bits_of(bitmap: torch.Tensor, device: torch.device) -> int:
    """log2 of the bits of a ``key_bitmap`` (int32 [2^bbits / 32],
    5 <= bbits <= 62), checked."""
    _check_tensor("bitmap", bitmap, torch.int32, 1, device)
    words = bitmap.numel()
    if words < 1 or words & (words - 1) or words.bit_length() + 4 > 62:
        raise ValueError(f"bitmap must hold 2^b words, 0 <= b <= 57, got {words}")
    return words.bit_length() + 4


def count_codes_(cov: torch.Tensor, keys: torch.Tensor, directory: torch.Tensor,
                 bitmap: torch.Tensor, codes: torch.Tensor, k: int) -> None:
    """cov[i] += the windows of a chromosome's genome rows whose value is
    keys[i], in place.

    cov int32 [M]; keys int64 [M], unique and sorted by unsigned value;
    directory int32 [2^bits + 1], the keys' ``key_directory``; bitmap int32
    [2^bbits / 32], the keys' ``key_bitmap`` (the kernel reads it, the
    plain version needs none); codes uint8 [n], the chromosome's base codes
    (0..3, 4 = ambiguous); all contiguous, on one device; 1 <= k <= 28.
    The count is not capped."""
    bits = _check_table(cov, keys, directory)
    bbits = _bitmap_bits_of(bitmap, cov.device)
    _check_tensor("codes", codes, torch.uint8, 1, cov.device)
    _check_k(k)
    if cov.device.type == "cpu":
        count_codes_plain(cov, keys, codes, k)
        return
    if cov.device.type != "cuda":
        raise ValueError(f"count_codes_ runs on cpu or cuda, not {cov.device}")
    m, rows = keys.numel(), genome_rows(codes.numel(), k)
    if m == 0 or rows == 0:
        return
    # a chromosome a launch up to the fused add's STAGE_POSITIONS positions
    chunk = max(1, STAGE_POSITIONS // (GENOME_COLS - k + 1))
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        _run("count_codes", cov.device, lambda lib, stream: lib.vg_count_codes(
            cov.data_ptr(), keys.data_ptr(), m, directory.data_ptr(), bits,
            bitmap.data_ptr(), bbits, codes.data_ptr(), codes.numel(), r0, n, k,
            stream))
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


def _bad_offsets() -> ValueError:
    return ValueError("offsets must start at 0, never decrease and end within codes")


def context_window_counts(codes: torch.Tensor, offsets: torch.Tensor,
                          ids: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [len(ids)] on the card: the windows of context ids[j] that emit
    (the long route's count pass).  Arguments as ``sketch_contexts``'s, on
    a CUDA device; ids int64, contiguous."""
    counts = torch.empty(ids.numel(), dtype=torch.int64, device=codes.device)
    _run("sketch_contexts", codes.device, lambda lib, stream: lib.vg_context_counts(
        codes.data_ptr(), offsets.data_ptr(), ids.data_ptr(), ids.numel(), k,
        counts.data_ptr(), stream))
    return counts


def _long_route(codes, offsets, ids, k, counts, out) -> None:
    """The contexts ids: their windows' values by the count and values
    passes, deduplicated with torch sorts, the uniques written at
    out[offsets[c]...] and their number at counts[c]."""
    dev = codes.device
    lc = context_window_counts(codes, offsets, ids, k)
    ends = torch.cumsum(lc, 0)
    raw = torch.empty(int(ends[-1]), dtype=torch.int64, device=dev)
    starts = ends - lc
    _run("sketch_contexts", dev, lambda lib, stream: lib.vg_context_values(
        codes.data_ptr(), offsets.data_ptr(), ids.data_ptr(), ids.numel(), k,
        starts.data_ptr(), raw.data_ptr(), stream))
    values, ustarts = dedup_contexts(raw, lc)
    unique = ustarts[1:] - ustarts[:-1]
    slot = (torch.repeat_interleave(offsets[ids] - ustarts[:-1], unique)
            + torch.arange(values.numel(), device=dev))
    out[slot] = values
    counts[ids] = unique


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
    dev, n_ctx = codes.device, offsets.numel() - 1
    if dev.type == "cpu" or n_ctx == 0:
        if bool((offsets[0] != 0) | (offsets[-1] > codes.numel())
                | (offsets[1:] < offsets[:-1]).any()):
            raise _bad_offsets()
        if dev.type == "cpu":
            return sketch_contexts_plain(codes, offsets, k)
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    status = torch.zeros(2, dtype=torch.int32, device=dev)
    counts = torch.empty(n_ctx, dtype=torch.int64, device=dev)
    out = torch.empty(max(1, codes.numel()), dtype=torch.int64, device=dev)
    _run("sketch_contexts", dev, lambda lib, stream: lib.vg_context_short(
        codes.data_ptr(), codes.numel(), offsets.data_ptr(), n_ctx, k,
        CONTEXT_TILE, counts.data_ptr(), out.data_ptr(), status.data_ptr(),
        stream))
    starts = torch.zeros(n_ctx + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    bad, n_long, total = torch.cat([status.long(), starts[-1:]]).tolist()
    if bad:
        raise _bad_offsets()
    if n_long:
        # the short kernel marked the long contexts' counts -1
        _long_route(codes, offsets, torch.nonzero(counts < 0).flatten(), k,
                    counts, out)
        torch.cumsum(counts, 0, out=starts[1:])
        total = int(starts[-1])
        LONG_ROUTE["contexts"] += n_long
    values = torch.empty(total, dtype=torch.int64, device=dev)
    _run("sketch_contexts", dev, lambda lib, stream: lib.vg_context_compact(
        out.data_ptr(), offsets.data_ptr(), starts.data_ptr(), n_ctx,
        values.data_ptr(), stream))
    LAUNCHES["sketch_contexts"] += 1
    return values, starts
