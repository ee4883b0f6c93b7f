"""Several processes on ``torch.distributed``: file assignment, the count
merge and the result union.

Port of ``varigraph_tpu/parallel/dist.py`` (jax.distributed).  Topology as
there: every process streams its round-robin share of a sample's FASTQ
files into its own copy of the table, the coverage and read-base totals
merge with one all-reduce, each process scores its round-robin share of the
windows, and the per-process results merge with one all-gather; rank 0
writes the VCF and the counts checkpoint.

The collectives run on the ``gloo`` backend with their payload on the host,
as the JAX merges return host arrays (``multihost_utils.process_allgather``):
gloo runs in the CPU tests, and NCCL refuses two ranks on one card, which is
how a one-card machine runs two processes.  Every collective has the process
group's timeout; a rank that exits closes its connections, so its peers'
next collective fails instead of waiting.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.log import log

# how long a collective (and the start-up rendezvous) waits for the other
# processes: a slow rank (an unequal share of the reads) must fit inside it
TIMEOUT = datetime.timedelta(hours=2)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the process group.

    coordinator "HOST:PORT": rank 0 listens there (``tcp://HOST:PORT``).
    Whatever is not given comes from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), the counterpart of the
    TPU runtime's autodetect.  On CUDA each process takes the local card
    ``LOCAL_RANK`` (default: its rank) modulo the local count."""
    env = os.environ
    try:
        rank = process_id if process_id is not None else int(env["RANK"])
        world = (num_processes if num_processes is not None
                 else int(env["WORLD_SIZE"]))
        if coordinator is None:
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    except KeyError as e:
        raise ValueError(
            f"multi-process run: {e.args[0]} is not set; pass --coordinator, "
            "--num-processes and --process-id, or start under torchrun"
        ) from None
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in [0, {world})")
    dist.init_process_group(backend="gloo", init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    log(f"distributed initialized: process {rank}/{world} "
        f"(gloo, coordinator {coordinator})")


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def assign_files_to_process(files: list[str]) -> list[str]:
    """Round-robin FASTQ file assignment per process."""
    pid, n = process_index(), process_count()
    return [f for i, f in enumerate(files) if i % n == pid]


def merge_counts_across_hosts(cov: torch.Tensor, read_base: int) -> int:
    """Sum every process's coverage into ``cov`` (int32, in place) and
    return the summed read-base total; every process ends with the same
    state.

    One all-reduce of the coverage and the base count, in int64 on the host.
    The JAX merge sums in uint32; both give the same counts below 2^31, and
    int32 coverage saturates there.  Saturation to the u8 'c' applies after
    the merge, as in the reference's single accumulation
    (src/fastq_kmer.cpp:126-141)."""
    buf = torch.empty(cov.numel() + 1, dtype=torch.int64)
    buf[:-1] = cov.cpu()
    buf[-1] = read_base
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    cov.copy_(buf[:-1].clamp_(max=np.iinfo(np.int32).max).to(cov.device))
    total = int(buf[-1])
    log(f"merged counts from {process_count()} hosts "
        f"({total / 1e9:.2f} Gb total)", func="merge_counts_across_hosts")
    return total


def merge_results_across_hosts(results: dict) -> dict:
    """Union the per-process window-scoring results (each process scores
    its round-robin share of the windows) in rank order; every process
    returns the same merged dict."""
    parts: list = [None] * process_count()
    dist.all_gather_object(parts, results)
    merged: dict = {}
    for part in parts:
        merged.update(part)
    log(f"merged scoring results from {process_count()} hosts "
        f"({len(merged)} records)", func="merge_results_across_hosts")
    return merged
