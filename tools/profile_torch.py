"""Where the time goes on the torch port's main path, on one CUDA card.

    python3 tools/profile_torch.py

Simulates the smoke run's reads (chip_smoke.simulate_reads) over the
committed 2 Mb graph, runs the genotype CLI once to warm up (kernel build,
CUDA start-up), then:

  * times the counting components apart: the host feed alone (FASTQ parse
    and packing), the pinned host-to-device copies, and the packed-read
    counter that sketches and joins each batch in one kernel (CUDA events,
    per batch);
  * profiles count_reads and genotype_torch with torch.profiler and prints,
    for each, the wall time, the summed device time of its kernels and
    copies, the device's idle share (1 - device time / wall) and the top
    operations by device time;
  * profiles construct the same way at the smoke's realistic size (a 100 Mb
    genome and 50,000 sites x 50 samples, chip_smoke.make_big_inputs): the
    whole of construct_graph_index, then its genome-count phase alone.

The profiler adds host overhead to every operation, so its walls are upper
bounds; the component times are taken without it.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.genotype.counting import count_reads  # noqa: E402
from varigraph_tpu_torch.genotype.coverage import estimate_hap_coverage  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import graph2node  # noqa: E402
from varigraph_tpu_torch.genotype.engine_torch import genotype_torch  # noqa: E402
from varigraph_tpu_torch.index.build import (  # noqa: E402
    construct_graph_index, make_genome_cbf)
from varigraph_tpu_torch.index.serialize import load_graph  # noqa: E402
from varigraph_tpu_torch.io.fasta import read_fasta  # noqa: E402
from varigraph_tpu_torch.io.fastq import stream_packed_batches_multi  # noqa: E402
from varigraph_tpu_torch.ops.join_cuda import count_packed_  # noqa: E402


def profiled(label, fn) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # each kernel's time appears twice: as the kernel's own event and in the
    # self device time of the operation that launched it.  The sum takes the
    # kernels and copies; the list names the operations.
    events = prof.key_averages()
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA) / 1e6
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{label}: wall {wall:.3f} s (profiled), device time {dev:.3f} s, "
          f"device idle share {1 - dev / wall:.3f}")
    for e in ops[:12]:
        print(f"    {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} "
              f"calls  {e.key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch: torch finds no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    k, B, L = chip_smoke.K, chip_smoke.BATCH, chip_smoke.READ_LEN_PAD
    with tempfile.TemporaryDirectory() as work:
        cfg_path, fq = chip_smoke.simulate_reads(work)
        chip_smoke.run_main_path("cuda", work, cfg_path,
                                 os.path.join(work, "counts.npz"))
        gi = load_graph(os.path.join(chip_smoke.FIXTURE, "graph.vgt"), device=dev)
        graph2node(gi)

        print("== counting components")
        t0 = time.perf_counter()
        batches = [p for p, _ in stream_packed_batches_multi([fq], B, L, k)]
        print(f"  host feed alone: {time.perf_counter() - t0:.3f} s for "
              f"{len(batches)} batches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uploaded = [torch.from_numpy(p).pin_memory().to(dev, non_blocking=True)
                    for p in batches]
        torch.cuda.synchronize()
        print(f"  pinned copies to the device: {time.perf_counter() - t0:.3f} s")
        directory = gi.table.directory()
        ms = []
        for packed in uploaded:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            count_packed_(gi.table.cov, gi.table.keys, directory, packed, k)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        print(f"  packed counter per batch: median {statistics.median(ms):.4f} "
              f"ms (sum {sum(ms) / 1e3:.4f} s)")

        print("== profiles")
        gi.table.reset_cov()
        read_base = [0]

        def count():
            read_base[0] = count_reads(gi.table, [fq], k, B, L)

        profiled("count_reads", count)
        cfg = VarigraphConfig(device="cuda")
        hap_cov = estimate_hap_coverage(
            gi.table.cov_u8(), gi.table.freq_np(), gi.table.hap_words_np(),
            gi.nhap, gi.vcf_ploidy, cfg.sample_ploidy,
            read_base[0] / gi.genome_size, cfg.use_depth)
        profiled("genotype_torch",
                 lambda: genotype_torch(gi, cfg, hap_cov, 0, device=dev))

        print(f"== construct at {chip_smoke.BIG_MB} Mb")
        ref, vcf, _, _ = chip_smoke.make_big_inputs(work)
        ccfg = VarigraphConfig(ref_file=ref, vcf_file=vcf, kmer_len=k,
                               device="cuda")
        profiled("construct_graph_index", lambda: construct_graph_index(ccfg))
        genome, _, size = read_fasta(ref)
        profiled("make_genome_cbf",
                 lambda: make_genome_cbf(genome, size, k, 0, dev).occupancy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
