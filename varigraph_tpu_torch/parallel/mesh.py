"""A mesh of torch devices, and data-parallel read counting over it.

Port of ``varigraph_tpu/parallel/mesh.py``.  The JAX mesh is a
``jax.sharding.Mesh`` whose functions are shard_map'd; here a mesh is a list
of ``torch.device``, and each function loops over it, launching on each
device in turn (launches are asynchronous, so real devices overlap).  A mesh
may name one device several times: n logical shards of one card run the same
per-shard kernels, shard arithmetic and merges as n cards do.

What uses a mesh:
  * read counting, replicated-table mode (genotype/counting.count_reads, the
    JAX ``make_count_batch_replicated_packed`` as wired in
    genotype/counting.py:237-266): every device holds the keys and an int32
    delta of its own; batches go round-robin over the devices through the
    same sketch and counting join; the deltas are summed into table.cov at
    the end.  Integer addition commutes, so the coverage equals the
    single-device coverage exactly.
  * window-sharded forward/backward (genotype/engine_torch.genotype_torch,
    the JAX engine_jax.py:604-625).
  * the position-range-sharded genome filter (ops/cbf.ShardedCBF, taken by
    index/build.make_genome_cbf, the JAX mesh.py:205-309).

Not ported: the hash-range-sharded counting (``shard_table_arrays``,
``make_count_batch_hash_sharded``, ``make_count_super_hash_sharded``) and
``make_hom_histogram``; see ROADMAP.md "Do not port".
"""

from __future__ import annotations

import torch

from . import dist


class Mesh:
    """The devices of a mesh, in shard order; repeats are allowed."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int = 0, device: torch.device | str = "cuda") -> Mesh:
    """The mesh of a run on ``device``: on CUDA, cuda:0 .. cuda:n-1, where
    n_devices = 0 means every local card and a larger n is capped at the
    local count (as the JAX make_mesh takes the first n local devices); on
    the CPU, the one CPU device.  In a run of several processes, each of
    which sees every card of its host, n_devices = 0 means the process's own
    card (``parallel/dist.initialize_distributed`` picks it): JAX's local
    devices of a process that owns one card."""
    device = torch.device(device)
    if device.type != "cuda":
        return Mesh([device])
    if n_devices <= 0 and dist.process_count() > 1:
        return Mesh([torch.device("cuda", torch.cuda.current_device())])
    local = torch.cuda.device_count()
    n = local if n_devices <= 0 else min(n_devices, local)
    return Mesh([torch.device("cuda", i) for i in range(n)])
