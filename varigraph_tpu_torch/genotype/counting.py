"""Read k-mer counting against the graph table.

Port of ``varigraph_tpu/genotype/counting.py`` for one device.  Replaces the
reference's thread-pooled per-read hash-map probing (src/fastq_kmer.cpp:65-187,
kmer_sketch_fastq at src/kmer.cpp:110-149) with:

  FASTQ stream -> packed [B, L/4+2] batches (host) -> pinned, asynchronous
  copy to the device -> sketch (ops/kmer.sketch_packed) -> counting join
  (csrc/join.cu) into table.cov, in place.

One join serves every table size: a search of the device-resident table per
query, so there is no small/large-table switch and no superbatching.
"""

from __future__ import annotations

import torch

from ..io.fastq import stream_packed_batches_multi
from ..ops.join_cuda import count_join_
from ..ops.kmer import sketch_packed
from ..ops.table import KmerTable
from ..utils.log import log


def count_reads(
    table: KmerTable,
    fastq_files: list[str],
    k: int,
    batch_size: int,
    max_len: int,
    io_threads: int = 4,
    join=count_join_,
) -> int:
    """Stream all files and add their k-mer counts to table.cov in place, on
    the table's device.  Returns the total number of bases read.

    io_threads: FASTQ files read concurrently (CLI -t).  join: the counting
    join, ``count_join_`` (the CUDA kernel on a CUDA table); a check can pass
    the plain ``ops.table.count_join`` to recount the same batches."""
    device = table.device
    pin = device.type == "cuda"
    max_len = (max_len + 3) // 4 * 4  # packed rows need L % 4 == 0
    read_base = 0
    nbatches = 0
    for path in fastq_files:
        log(f"Collecting kmers from read on device: {path}", func="count_reads")
    for packed, bases in stream_packed_batches_multi(
        fastq_files, batch_size, max_len, k, max_parallel=max(io_threads, 1)
    ):
        host = torch.from_numpy(packed)
        if pin:
            host = host.pin_memory()
        values, emit = sketch_packed(host.to(device, non_blocking=pin), k)
        # positions 0..k-2 of a row can never emit (the window is incomplete)
        values, emit = values[:, k - 1 :], emit[:, k - 1 :]
        join(table.cov, table.keys, values.reshape(-1), emit.reshape(-1))
        read_base += bases
        nbatches += 1
    if pin:
        torch.cuda.synchronize(device)
    log(f"Processed {nbatches} batches, {read_base / 1e9:.2f} Gb "
        f"(table on {device})", func="count_reads")
    return read_base
