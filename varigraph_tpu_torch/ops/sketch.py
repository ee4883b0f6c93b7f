"""Construct's genome and context sketches: the plain torch versions and the
host side.

``count_codes_plain(cov, keys, codes, k)`` adds to ``cov`` the exact genome
count of one chromosome's base codes: every window that its genome rows
(``ops/cbf.genome_rows``) emit, joined against the sorted keys.  It is the
port of ``_count_codes_stack`` (``varigraph_tpu/ops/exact_count.py:44``):
the rows GENOME_ROWS at a time through the torch ``sketch_codes``, then
``ops/table.count_join``.  ``key_bitmap_plain(keys, bbits)`` is the plain
version of the keys' occupancy bitmap, which the card's count tests before
the directory (``bitmap_bits`` sizes it).

``sketch_contexts_plain(codes, offsets, k)`` returns each context's unique
k-mer values in unsigned order as a CSR ``(values, starts)``: context c's are
values[starts[c]:starts[c + 1]].  The contexts are one concatenated code
buffer with int64 offsets (``encode_contexts``).  It is the port of
``_sketch_contexts`` (``varigraph_tpu/index/build.py:162``): the contexts in
order of length, in batches of at most CTX_BATCH_AREA bases, each padded to
its longest context (code 4, which never emits), through the torch
``sketch_codes``, then ``np.unique`` per context on the host.

The CUDA kernels with these contracts (``csrc/sketch.cu``) are wrapped by
``ops/sketch_cuda.py``.  Its context sketch deduplicates each context of at
most ``CONTEXT_TILE`` windows inside the kernel, and the few longer ones
(the long route) with ``dedup_contexts``.
"""

from __future__ import annotations

import numpy as np
import torch

from .cbf import GENOME_ROWS, genome_row_codes, genome_rows
from .kmer import sketch_codes
from .sketch_ref import encode_bases_np
from .table import _ORDER_FLIP, count_join, directory_shift

# the plain context sketch: cap on a padded batch's area (rows x its longest
# context); a context longer than this takes a batch of its own
CTX_BATCH_AREA = 8 * 1024 * 1024
# the exact count's occupancy bitmap: 2^5 bits a key or more, at most 2^27
# bits (16 MB, which stays in the H100's 50 MB L2 beside the directory)
_BITMAP_BITS_PER_KEY_LOG2, _MAX_BITMAP_BITS = 5, 27


def encode_contexts(contexts: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Host side: context strings -> (uint8 codes of all of them one after
    another, int64 offsets [C + 1]); context c is codes[offsets[c]:offsets[c
    + 1]]."""
    offsets = np.zeros(len(contexts) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, contexts), np.int64, len(contexts)),
              out=offsets[1:])
    return encode_bases_np("".join(contexts)), offsets


def count_codes_plain(cov: torch.Tensor, keys: torch.Tensor,
                      codes: torch.Tensor, k: int) -> None:
    """cov[i] += the windows of a chromosome's genome rows whose value is
    keys[i], in place (see the module docstring).  cov int32 [M], keys int64
    [M] unique and sorted by unsigned value, codes uint8 [n]."""
    rows = genome_rows(codes.numel(), k)
    for r0 in range(0, rows, GENOME_ROWS):
        batch = genome_row_codes(codes, k, r0, min(rows, r0 + GENOME_ROWS))
        values, emit = sketch_codes(batch, k)
        # positions 0..k-2 of a row never emit (incomplete window)
        count_join(cov, keys, values[:, k - 1:].reshape(-1),
                   emit[:, k - 1:].reshape(-1))


def bitmap_bits(m: int) -> int:
    """The occupancy bitmap's size (as log2 of its bits) for an m-key
    table: 2^5 bits a key, at least 32 bits, at most 2^27."""
    b = (max(m, 1) - 1).bit_length() + _BITMAP_BITS_PER_KEY_LOG2
    return min(max(b, 5), _MAX_BITMAP_BITS)


def key_bitmap_plain(keys: torch.Tensor, bbits: int) -> torch.Tensor:
    """int32 [2^bbits / 32] on keys' device: bit q & 31 of word q >> 5 is
    set where some key's top bbits bits, below the largest key's highest
    (``table.directory_shift``, as the key directory cuts them), are q.  A
    value whose q bit is clear is no key; the exact count
    (``sketch_cuda.count_codes_``) tests it before the directory.  keys
    int64 [M], unique and sorted by unsigned value."""
    words = torch.zeros(1 << (bbits - 5), dtype=torch.int64, device=keys.device)
    if keys.numel():
        shift = directory_shift(int(keys[-1]) & ((1 << 64) - 1), bbits)
        q = torch.unique((keys >> shift) & ((1 << bbits) - 1))
        words.index_add_(0, q >> 5, torch.ones_like(q) << (q & 31))
    # the uint32 words as int32 bit patterns
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _csr(per_context: list[np.ndarray], device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-context uint64 arrays -> (values int64, starts int64) on device."""
    starts = np.zeros(len(per_context) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, per_context), np.int64, len(per_context)),
              out=starts[1:])
    values = (np.concatenate(per_context) if starts[-1]
              else np.empty(0, np.uint64))
    return (torch.from_numpy(values.view(np.int64)).to(device),
            torch.from_numpy(starts).to(device))


def sketch_contexts_plain(codes: torch.Tensor, offsets: torch.Tensor,
                          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values int64, starts int64 [C + 1]) on codes' device: each context's
    unique k-mer values in unsigned order (see the module docstring)."""
    dev = codes.device
    off = offsets.cpu().numpy()
    lens = np.diff(off)
    results = [np.empty(0, np.uint64)] * len(lens)
    order = np.argsort(lens, kind="stable")
    last = max(codes.numel() - 1, 0)
    i = 0
    while i < len(order) and codes.numel():
        j = i + 1  # contexts go in order of length: the last sets the width
        while j < len(order) and (j - i + 1) * lens[order[j]] <= CTX_BATCH_AREA:
            j += 1
        idx = order[i:j]
        i = j
        col = torch.arange(max(1, int(lens[idx[-1]])), device=dev)
        first = torch.from_numpy(off[idx]).to(dev)
        n = torch.from_numpy(lens[idx]).to(dev)
        pos = (first[:, None] + col[None, :]).clamp_(max=last)
        batch = torch.where(col[None, :] < n[:, None], codes[pos], 4)
        values, emit = sketch_codes(batch, k)
        values = values.cpu().numpy().view(np.uint64)
        emit = emit.cpu().numpy()
        for row, c in enumerate(idx):
            results[c] = np.unique(values[row][emit[row]])
    return _csr(results, dev)


def dedup_contexts(values: torch.Tensor, counts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Values written context after context (counts[c] of context c) ->
    the CSR of each context's unique values in unsigned order, with torch
    sorts on their device: the values by unsigned value (sign bit flipped),
    then a stable sort by context, then adjacent duplicates dropped."""
    dev = values.device
    n_ctx = counts.numel()
    starts = torch.zeros(n_ctx + 1, dtype=torch.int64, device=dev)
    if values.numel() == 0:
        return values, starts
    ctx = torch.repeat_interleave(torch.arange(n_ctx, device=dev), counts)
    v, order = torch.sort(values ^ _ORDER_FLIP)
    ctx, order = torch.sort(ctx[order], stable=True)
    v = v[order]
    new = torch.ones(v.shape, dtype=torch.bool, device=dev)
    new[1:] = (v[1:] != v[:-1]) | (ctx[1:] != ctx[:-1])
    torch.cumsum(torch.bincount(ctx[new], minlength=n_ctx), 0, out=starts[1:])
    return v[new] ^ _ORDER_FLIP, starts
