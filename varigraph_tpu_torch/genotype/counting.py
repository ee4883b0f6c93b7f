"""Read k-mer counting against the graph table.

Port of ``varigraph_tpu/genotype/counting.py``.  Replaces the
reference's thread-pooled per-read hash-map probing (src/fastq_kmer.cpp:65-187,
kmer_sketch_fastq at src/kmer.cpp:110-149) with:

  FASTQ stream -> packed [B, L/4+2] batches (host) -> pinned, asynchronous
  copy to the device -> sketch (ops/kmer.sketch_packed) -> counting join
  (csrc/join.cu) into table.cov, in place.

One join serves every table size: a search of the device-resident table per
query, so there is no small/large-table switch and no superbatching.  On a
mesh of several devices (parallel/mesh.py) the counting is data-parallel
with a replicated table: each device holds the keys and an int32 delta,
batches go round-robin over the devices, and the deltas are summed into
table.cov at the end (the JAX replicated-table mode, counting.py:237-266;
the hash-range-sharded mode is not ported).
"""

from __future__ import annotations

import torch

from ..io.fastq import stream_packed_batches_multi
from ..ops.join_cuda import count_join_
from ..ops.kmer import sketch_packed
from ..ops.table import KmerTable
from ..parallel.mesh import Mesh
from ..utils.log import log


def count_reads(
    table: KmerTable,
    fastq_files: list[str],
    k: int,
    batch_size: int,
    max_len: int,
    io_threads: int = 4,
    join=count_join_,
    mesh: Mesh | None = None,
) -> int:
    """Stream all files and add their k-mer counts to table.cov in place.
    Returns the total number of bases read.

    io_threads: FASTQ files read concurrently (CLI -t).  join: the counting
    join, ``count_join_`` (the CUDA kernel on a CUDA table); a check can pass
    the plain ``ops.table.count_join`` to recount the same batches.  mesh:
    with more than one device, batches go round-robin over its devices, each
    counting into a delta of its own; otherwise they count on the table's
    device, straight into table.cov."""
    if mesh is not None and mesh.size > 1:
        devices = list(mesh.devices)
        keys = [table.keys.to(d) for d in devices]
        accs = [torch.zeros(table.size, dtype=torch.int32, device=d)
                for d in devices]
        log(f"counting data-parallel over {len(devices)} devices",
            func="count_reads")
    else:
        devices, keys, accs = [table.device], [table.keys], [table.cov]
    max_len = (max_len + 3) // 4 * 4  # packed rows need L % 4 == 0
    read_base = 0
    nbatches = 0
    for path in fastq_files:
        log(f"Collecting kmers from read on device: {path}", func="count_reads")
    for packed, bases in stream_packed_batches_multi(
        fastq_files, batch_size, max_len, k, max_parallel=max(io_threads, 1)
    ):
        j = nbatches % len(devices)
        device = devices[j]
        pin = device.type == "cuda"
        host = torch.from_numpy(packed)
        if pin:
            host = host.pin_memory()
        values, emit = sketch_packed(host.to(device, non_blocking=pin), k)
        # positions 0..k-2 of a row can never emit (the window is incomplete)
        values, emit = values[:, k - 1 :], emit[:, k - 1 :]
        join(accs[j], keys[j], values.reshape(-1), emit.reshape(-1))
        read_base += bases
        nbatches += 1
    if accs[0] is not table.cov:
        for acc in accs:
            table.cov += acc.to(table.device)
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    log(f"Processed {nbatches} batches, {read_base / 1e9:.2f} Gb "
        f"(table on {table.device})", func="count_reads")
    return read_base
