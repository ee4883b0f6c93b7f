"""Host (numpy/pure-Python) reference implementation of the canonical k-mer
sketch.

This is the behavioral specification: a faithful re-derivation of the rolling
sketch in reference src/kmer.cpp:20-52 (all four variants share the same scan;
only the sink differs).  It is used as the oracle in unit tests and as a host
fallback for very small strings.

Exact semantics reproduced (see reference src/kmer.cpp):
  * 2-bit base codes per seq_nt4_table (A=0 C=1 G=2 T/U=3, else ambiguous).
  * forward register  kmer0 = (kmer0 << 2 | c) & mask        (:37)
  * reverse register  kmer1 = (kmer1 >> 2) | (3^c) << 2(k-1) (:38)
  * registers are NOT reset at ambiguous bases -- only the run counter l is
    (:48); so palindrome checks during the warmup after an N can involve stale
    register bits.  Emitted windows themselves never straddle an N because
    emission requires l >= k.
  * palindromic windows (kmer0 == kmer1) are skipped without incrementing l
    (:39), which lengthens the warmup.
  * emitted value: hash64(min(fwd, rc), mask) << 8 | k       (:43)
"""

from __future__ import annotations

import numpy as np

# seq_nt4_table (reference include/seq_nt4_table.hpp:5-22)
SEQ_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _b, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    SEQ_NT4_TABLE[ord(_b)] = _c
    SEQ_NT4_TABLE[ord(_b.lower())] = _c


def encode_bases_np(seq: str | bytes) -> np.ndarray:
    """String -> uint8 code array (0..3 bases, 4 = ambiguous)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def hash64_np(key: int, mask: int) -> int:
    """Invertible integer finalizer (reference include/hash64.hpp:5-14)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def sketch_ref(seq: str | bytes, k: int) -> list[int]:
    """Rolling canonical sketch; returns the emitted 64-bit encoded k-mers in
    sequence order (duplicates preserved)."""
    assert 0 < k <= 28
    codes = encode_bases_np(seq)
    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    kmer0 = 0
    kmer1 = 0
    l = 0
    out: list[int] = []
    for c in codes:
        c = int(c)
        if c < 4:
            kmer0 = ((kmer0 << 2) | c) & mask
            kmer1 = (kmer1 >> 2) | ((3 ^ c) << shift1)
            if kmer0 == kmer1:
                continue  # palindromic window: skip, do not advance l
            z = 0 if kmer0 < kmer1 else 1
            l += 1
            if l >= k:
                canonical = kmer0 if z == 0 else kmer1
                out.append((hash64_np(canonical, mask) << 8) | k)
        else:
            l = 0
    return out
