"""FASTA reading (plain or gzip).

Host-side replacement for the reference's kseq-based build_fasta_index
(src/construct_index.cpp:85-139); a copy of ``varigraph_tpu/io/fasta.py``.
"""

from __future__ import annotations

import gzip
import os

from ..utils.log import log


def _open_text(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str) -> tuple[dict[str, str], dict[str, int], int]:
    """Parse a FASTA file.

    Returns (seq_map, len_map, genome_size).  Chromosome names are the first
    whitespace-delimited token of the header, matching kseq's ks->name.s.
    Raises on chromosomes longer than 2^32-1 (construct_index.cpp:120-125).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"'{path}': No such file or directory.")

    seq_map: dict[str, str] = {}
    len_map: dict[str, int] = {}
    genome_size = 0
    name = None
    parts: list[str] = []

    def flush():
        nonlocal genome_size
        if name is None:
            return
        seq = "".join(parts)
        if len(seq) > 0xFFFFFFFF:
            raise ValueError(f"'{name}' length is greater than 4,294,967,295.")
        seq_map[name] = seq
        len_map[name] = len(seq)
        genome_size += len(seq)

    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                flush()
                name = line[1:].split()[0] if len(line) > 1 else ""
                parts = []
            else:
                parts.append(line)
        flush()

    log(f"Size of reference genome: {genome_size / 1e6:.2f} Mb")
    return seq_map, len_map, genome_size
