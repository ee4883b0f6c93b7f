"""Canonical k-mer sketch on torch tensors.

Port of ``varigraph_tpu/ops/kmer.py``.  The JAX package computes the two
rolling registers with an associative scan; here they are the reference's
sequential form (reference src/kmer.cpp:20-52): one loop over the L
positions, batched over reads, so the port also checks the JAX scan
independently.

  forward register   x -> ((x << 2) | c) & mask          (kmer.cpp:37)
  reverse register   x -> (x >> 2) | (3^c) << 2(k-1)     (kmer.cpp:38)

Semantics kept exactly: an ambiguous base (code >= 4) leaves both registers
as they are but resets the run counter (kmer.cpp:48); a palindromic window
(forward == reverse) is skipped without advancing the counter (:39); a
position emits once the counter reaches k, so the warmup is k-1 bases.

Values are uint64 encodings ``hash64(canonical) << 8 | k`` carried as int64
bit patterns.  Registers stay below 2^56, so every right shift sees a
non-negative value and an arithmetic shift is exact; left shifts and adds
wrap in int64 as they do in uint64.
"""

from __future__ import annotations

import numpy as np
import torch

from .sketch_ref import encode_bases_np

# encoded value layout: hash64(kmer) << 8 | span (reference src/kmer.cpp:43)
KMER_SPAN_BITS = 8
PACKED_LEN_BYTES = 2  # u16-LE row length appended to each packed row


def encode_bases(seq: str | bytes) -> np.ndarray:
    """Host helper: DNA string -> uint8 codes (0..3, 4 = ambiguous)."""
    return encode_bases_np(seq)


def pack_seqs(seqs: list[bytes | str], max_len: int | None = None) -> np.ndarray:
    """Pack variable-length sequences into a [B, L] uint8 code matrix.

    Padding uses code 4 (ambiguous), which never emits and resets the run
    counter, so rows are fully independent.
    """
    if max_len is None:
        max_len = max((len(s) for s in seqs), default=1)
    out = np.full((len(seqs), max_len), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes = encode_bases_np(s)[:max_len]
        out[i, : len(codes)] = codes
    return out


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Invertible integer finalizer (reference include/hash64.hpp:5-14) on
    int64 tensors holding values below 2^56."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def sketch_codes(codes: torch.Tensor, k: int):
    """Canonical k-mer sketch over base codes.

    Args:
      codes: integer tensor [B, L], values 0..3 (bases) or >= 4 (ambiguous or
        padding).  Rows are independent sequences.
      k: k-mer size, 1..28 (56-bit packing).

    Returns:
      (values, emit): values int64 [B, L] holding the uint64 bit pattern of
      ``hash64(canonical) << 8 | k`` where emit is set and 0 elsewhere; emit
      bool [B, L], set where the reference's rolling scan emits.
    """
    if not 0 < k <= 28:
        raise ValueError(f"k must be in 1..28, got {k}")
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    codes = codes.to(torch.int64)
    B, L = codes.shape
    dev = codes.device
    fwd = torch.zeros(B, dtype=torch.int64, device=dev)
    rev = torch.zeros(B, dtype=torch.int64, device=dev)
    run = torch.zeros(B, dtype=torch.int32, device=dev)
    canon = torch.empty((B, L), dtype=torch.int64, device=dev)
    emit = torch.empty((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        c = codes[:, i]
        base = c < 4
        cb = torch.where(base, c, 0)
        fwd = torch.where(base, ((fwd << 2) | cb) & mask, fwd)
        rev = torch.where(base, (rev >> 2) | ((3 ^ cb) << shift1), rev)
        step = base & (fwd != rev)
        run = torch.where(base, run + step.to(torch.int32), 0)
        emit[:, i] = step & (run >= k)
        canon[:, i] = torch.minimum(fwd, rev)
    values = (hash64(canon, mask) << KMER_SPAN_BITS) | k
    return torch.where(emit, values, 0), emit


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """Decode the packed read feed.

    packed: uint8 [B, L//4 + 2] -- each row is L//4 bytes of 2-bit base codes
    (base i in bits 2*(i mod 4) of byte i//4) followed by a u16-LE valid
    length.  Returns uint8 [B, L]: 0..3 for the first ``length`` bases and 4
    (never emits) beyond.  The packing makes the host-to-device copy 4x
    smaller than one byte per base.
    """
    body = packed[:, :-PACKED_LEN_BYTES].to(torch.int32)
    ltail = packed[:, -PACKED_LEN_BYTES:].to(torch.int32)
    lengths = ltail[:, 0] | (ltail[:, 1] << 8)                    # [B]
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    c = ((body[:, :, None] >> shifts) & 3).reshape(body.shape[0], -1)
    pos = torch.arange(c.shape[1], dtype=torch.int32, device=packed.device)
    return torch.where(pos[None, :] < lengths[:, None], c, 4).to(torch.uint8)


def sketch_packed(packed: torch.Tensor, k: int):
    """sketch_codes over the packed feed (see unpack_2bit)."""
    return sketch_codes(unpack_2bit(packed), k)


def pack_codes_np(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host-side packer: [B, L] codes 0..4 + [B] valid lengths ->
    [B, L//4 + 2] rows.  Codes beyond ``lengths`` are ignored; rows must be
    prefix-valid (no interior >= 4 codes within ``lengths``)."""
    B, L = codes.shape
    if L % 4:
        raise ValueError(f"row length must be a multiple of 4, got {L}")
    c = np.where(codes > 3, 0, codes).astype(np.uint8).reshape(B, L // 4, 4)
    body = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)
    out = np.empty((B, L // 4 + PACKED_LEN_BYTES), np.uint8)
    out[:, : L // 4] = body
    lengths = lengths.astype(np.uint32)
    out[:, L // 4] = (lengths & 0xFF).astype(np.uint8)
    out[:, L // 4 + 1] = ((lengths >> 8) & 0xFF).astype(np.uint8)
    return out


def sketch_seq(seq: str | bytes, k: int) -> np.ndarray:
    """Convenience host wrapper: string -> emitted encoded k-mers (1-D
    uint64, in sequence order)."""
    codes = encode_bases_np(seq)
    if codes.size == 0:
        return np.empty(0, dtype=np.uint64)
    values, emit = sketch_codes(torch.from_numpy(codes[None, :]), k)
    return values[emit].cpu().numpy().view(np.uint64)
