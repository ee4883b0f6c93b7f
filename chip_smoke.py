#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (under $CUDA_HOME or /usr/local/cuda) and this
checkout; it imports nothing of JAX.  Phases, each of which must pass:

  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel builds (csrc/join.cu and csrc/cbf.cu, one nvcc each, started
     together), timed;
  3. the counting join kernel against its plain torch version on the card,
     exactly equal on edge cases, then both timed at the main path's batch
     shape (16384 reads x 134 query slots) against the test graph's table
     and against a 24M-key table;
  4. the main path: ``varigraph_tpu_torch.cli.main(["genotype", ...,
     "--device", "cuda"])`` on the committed 2 Mb graph
     (tests/fixtures/slice2m) with 20x reads simulated from sample S1's two
     haplotypes; the join must have launched once per batch, and S1's
     genotypes must agree with the VCF's truth at >= 99% of the sites;
  5. parity on the card: a recount with the plain join gives the kernel's
     coverage exactly, and the host oracle engine (engine_np) on the same
     counts gives the same GT at every site with GPP within 2e-3;
  6. construct on the card: ``cli.main(["construct", ..., "--device",
     "cuda"])`` on the fixture's inputs (k = 27, seed 0) must write a .vgt
     whose every member equals the committed, JAX-built graph.vgt; the
     filter kernels must have launched; genotyping the port-built graph must
     agree with the truth at >= 99% of the sites;
  7. the Bloom filter kernels against their plain torch version on the card,
     filter bytes and counts exactly equal on edge cases, then both timed at
     one genome batch (16384 x 134 keys, kh = 7) at m = 2^25 and 2^30;
  8. the exact-count regime (``_CBF_DEVICE_MAX`` set to 1): construct must
     launch the join, and every count it fed the table must equal the same
     counter run with the plain join on the card;
  9. construct at a realistic size: a 100 Mb, 2-chromosome genome and a VCF
     of 50,000 sites x 50 samples (tools/gen_big.py's generators), a
     2^30-cell (1 GiB) filter on the card; phase times, table checks, the
     file read back, and the kernel's filter equal to the plain version's
     after the first 32 genome batches;
 10. the reference graph.bin: the committed 2 Mb graph written as graph.bin,
     ``genotype --load-graph graph.bin --device cuda`` through the CLI (the
     join must launch, S1 must meet the 99% GT gate), the loaded table equal
     to the .vgt's, whether the rebuilt local bits equal the construct-time
     ones, and a timed graph.bin write and load of phase 9's 100 Mb graph;
 11. two processes: S1's reads split into two FASTQ files, two genotype CLI
     processes on the card joined by ``--coordinator localhost:PORT
     --num-processes 2`` (each under a timeout, both killed on failure),
     whose VCF must be byte-identical to one process's on the same files;
 12. the mesh: over the card's devices, or 2 logical shards of cuda:0 when
     there is one card.  Phase 9's 100 Mb genome filter built over 2 shards
     equals phase 9's one-device filter byte for byte; a 3-shard filter
     (m not a power of two) equals its plain version; construct of the 2 Mb
     fixture with the shard threshold forced equals the committed graph.vgt
     in every member; genotype over the mesh (replicated counting,
     window-sharded forward/backward) gives phase 4's coverage and VCF; and
     the per-shard kernels are timed at 2^29 cells per shard.

Each main path runs with the launch counts set to 0 just before it and read
just after.  Prints, before its last line, the kernels' JSON summary (launches
summed over the main paths; the filter kernels' entries also carry the
per-shard times, ``shard_ms`` and ``shard_plain_ms``); its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result line, when any phase fails or no CUDA device
is present.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gzip
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import varigraph_tpu_torch.genotype.pipeline as pipeline_mod
import varigraph_tpu_torch.index.build as build_mod
from varigraph_tpu_torch.cli import main as cli_main
from varigraph_tpu_torch.config import VarigraphConfig
from varigraph_tpu_torch.genotype.counting import count_reads
from varigraph_tpu_torch.genotype.coverage import estimate_hap_coverage
from varigraph_tpu_torch.genotype.engine_np import genotype_np, graph2node
from varigraph_tpu_torch.genotype.engine_torch import genotype_torch
from varigraph_tpu_torch.genotype.pipeline import load_counts
from varigraph_tpu_torch.index.interop import save_reference_graph_bin
from varigraph_tpu_torch.index.serialize import load_graph
from varigraph_tpu_torch.io.fasta import read_fasta
from varigraph_tpu_torch.ops import cbf_cuda, join_cuda
from varigraph_tpu_torch.ops.cbf import (CountingBloomFilter, ShardedCBF,
                                         cbf_add_plain, cbf_count_plain,
                                         make_seeds)
from varigraph_tpu_torch.ops.cuda_build import LAUNCHES
from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter
from varigraph_tpu_torch.ops.kmer import sketch_codes
from varigraph_tpu_torch.ops.table import count_join
from varigraph_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import gen_big  # noqa: E402
from data_gen import apply_haplotype, make_reads, write_fastq  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "slice2m")
K = 27
BATCH, READ_LEN_PAD = 16384, 160
MAIN_PATH_QUERIES = BATCH * (READ_LEN_PAD - (K - 1))   # 2,195,456
LARGE_TABLE_KEYS = 24_000_000
READ_SEED = 1
DEPTH, READ_LEN = 20.0, 150
MIN_GT_AGREEMENT = 0.99
GPP_TOL = 2e-3   # the JAX package's engine parity tolerance
TIMING_RUNS = 7
# construct at a realistic size (phase 9): the JAX package's 100 Mb rehearsal
BIG_MB, BIG_CHROMS, BIG_SITES, BIG_SAMPLES, BIG_SEED = 100, 2, 50_000, 50, 7
BIG_FILTER_CELLS = 1 << 30                     # 1 GiB of counters at 100 Mb
GENOME_BATCH_KEYS = 16384 * (160 - (K - 1))   # one genome batch, 2,195,456
CBF_TIMING_KH = 7                              # kh of the 2^30 filter
FILTER_CHECK_BATCHES = 32
PROCESS_TIMEOUT_S = 300                        # each CLI process of phase 11
SHARD_CELLS = 1 << 29                          # per-shard timing (phase 12)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ----------------------------------------------------------------- phase 3

def _kmer_values(n, gen, device, span=K):
    """Random encodings hash<<8|span below 2^63 (as int64)."""
    hi = torch.randint(0, 1 << 55, (n,), generator=gen, device=device)
    return (hi << 8) | span


def _join_case(keys, n_q, hit_rate, mask_rate, gen):
    q = _kmer_values(n_q, gen, keys.device)
    if keys.numel():
        hit = torch.rand(n_q, generator=gen, device=keys.device) < hit_rate
        pick = torch.randint(0, keys.numel(), (n_q,), generator=gen,
                             device=keys.device)
        q = torch.where(hit, keys[pick], q)
    mask = torch.rand(n_q, generator=gen, device=keys.device) < mask_rate
    return q, mask


def _sorted_unique(vals, n=None):
    """Unique values in unsigned 64-bit order (int64 bit patterns)."""
    flip = -(1 << 63)
    u = torch.unique(vals ^ flip) ^ flip
    return u if n is None else u[:n]


def join_cases(device):
    """The edge cases the kernel must get exactly right, as
    (name, keys, queries, mask)."""
    gen = torch.Generator(device=device).manual_seed(0)
    rnd = _sorted_unique(_kmer_values(5000, gen, device))
    q, m = _join_case(rnd, 200_000, 0.3, 0.9, gen)
    yield "random 30% hits, 90% mask", rnd, q, m
    odd = rnd[:1000 - 3]                                  # M % 128 != 0
    q, m = _join_case(odd, 50_000, 0.3, 0.9, gen)
    yield "M not a multiple of 128", odd, q, m
    v = _kmer_values(4000, gen, device, span=28)
    v[::2] |= -(1 << 63)
    k28 = _sorted_unique(v)
    q, m = _join_case(k28, 50_000, 0.5, 0.9, gen)
    yield "keys with bit 63 set (k = 28)", k28, q, m
    rep = torch.full((3 * 4096 + 1,), int(rnd[3]), dtype=torch.int64,
                     device=device)
    yield "one key repeated 3*4096+1 times", rnd, rep, torch.ones_like(rep, dtype=torch.bool)
    q, _ = _join_case(rnd, 10_000, 0.5, 1.0, gen)
    yield "all masked out", rnd, q, torch.zeros_like(q, dtype=torch.bool)
    yield "M = 0", rnd[:0], q, torch.ones_like(q, dtype=torch.bool)
    yield "Q = 0", rnd, q[:0], torch.ones(0, dtype=torch.bool, device=device)


def check_join(kernel, plain, device) -> int:
    """Kernel against plain on every case; returns the max abs difference
    (must be 0)."""
    worst = 0
    for name, keys, q, m in join_cases(device):
        a = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        b = torch.zeros_like(a)
        kernel(a, keys, q, m)
        plain(b, keys, q, m)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        err = int((a - b).abs().max()) if a.numel() else 0
        hits = int(a.sum())
        print(f"  join case {name}: M={keys.numel()} Q={q.numel()} "
              f"hits={hits} max_abs_err={err}")
        if err:
            fail(f"join kernel disagrees with plain on case '{name}'")
        worst = max(worst, err)
    return worst


def time_ms(call, before=None, runs=TIMING_RUNS) -> float:
    """Median ms of one ``call()``, timed with CUDA events after a warm-up;
    ``before()`` runs ahead of each timed call, outside the timing."""
    call()
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_join(fn, keys, q, m) -> float:
    """Median ms of one join call."""
    cov = torch.zeros(keys.numel(), dtype=torch.int32, device=keys.device)
    return time_ms(lambda: fn(cov, keys, q, m), before=cov.zero_)


# ----------------------------------------------------------------- phase 4

def simulate_reads(workdir: str, sample: str = "S1") -> tuple[str, str]:
    """Writes reads drawn from the sample's two haplotypes of the fixture
    and a samples.cfg; returns (cfg path, FASTQ path)."""
    genome = read_fasta(os.path.join(FIXTURE, "ref.fa.gz"))[0]
    with gzip.open(os.path.join(FIXTURE, "vars.vcf.gz"), "rt") as fh:
        vcf_text = fh.read()
    haps = [apply_haplotype(genome, vcf_text, sample, h) for h in (0, 1)]
    reads = make_reads(haps, np.random.default_rng(READ_SEED), depth=DEPTH,
                       read_len=READ_LEN)
    fq = os.path.join(workdir, f"{sample}.fq")
    write_fastq(fq, reads)
    cfg = os.path.join(workdir, "samples.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{sample} {fq}\n")
    print(f"  simulated {len(reads)} reads of {READ_LEN} bp at {DEPTH:g}x "
          f"from {sample}'s haplotypes")
    return cfg, fq


def truth_gts(sample: str = "S1") -> dict[tuple[str, int], list[int]]:
    out = {}
    with gzip.open(os.path.join(FIXTURE, "vars.vcf.gz"), "rt") as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            f = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                col = f.index(sample)
                continue
            gt = f[col].split(":")[0].replace("|", "/").split("/")
            out[(f[0], int(f[1]))] = sorted(int(g) for g in gt)
    return out


def called_gts(vcf_path: str) -> dict[tuple[str, int], list[int]]:
    out = {}
    with gzip.open(vcf_path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gt = dict(zip(f[8].split(":"), f[9].split(":")))["GT"]
            out[(f[0], int(f[1]))] = sorted(
                int(g) if g != "." else -1 for g in gt.split("/"))
    return out


def gt_agreement(vcf_path: str) -> tuple[int, int]:
    """(sites agreeing, sites); a site without a record counts as 0/0 (the
    writer leaves out 0/0 calls)."""
    truth = truth_gts()
    called = called_gts(vcf_path)
    agree = sum(called.get(site, [0, 0]) == gt for site, gt in truth.items())
    return agree, len(truth)


class _Tee(io.TextIOBase):
    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def run_cli(argv: list[str]) -> str:
    """Runs the port's CLI; returns its log."""
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = cli_main(argv)
    if rc != 0:
        fail(f"{argv[0]} CLI returned {rc}")
    return tee.buf.getvalue()


def run_main_path(device_name: str, workdir: str, cfg: str, counts: str,
                  graph: str = os.path.join(FIXTURE, "graph.vgt"),
                  out_name: str = "out") -> tuple[str, str]:
    """Runs the genotype CLI; returns (VCF path, its log)."""
    out_dir = os.path.join(workdir, out_name)
    log_text = run_cli(["genotype", "--load-graph", graph, "-s", cfg,
                        "--out-dir", out_dir, "--device", device_name,
                        "--save-counts", counts])
    return os.path.join(out_dir, "S1.varigraph.vcf.gz"), log_text


def phase_timings(log_text: str) -> dict[str, float]:
    t = {}
    for name, pat in (("counting", r"phase timing: counting ([\d.]+)s"),
                      ("coverage", r"phase timing: coverage model ([\d.]+)s"),
                      ("scoring", r"phase timing: scoring ([\d.]+)s"),
                      ("vcf", r"phase timing: vcf write ([\d.]+)s")):
        m = re.search(pat, log_text)
        if not m:
            fail(f"no '{name}' phase timing in the log")
        t[name] = float(m.group(1))
    m = re.search(r"engine timing: prep ([\d.]+)s emit ([\d.]+)s fb ([\d.]+)s "
                  r"posterior ([\d.]+)s", log_text)
    if not m:
        fail("no engine timing in the log")
    for i, name in enumerate(("prep", "emit", "fb", "posterior")):
        t[name] = float(m.group(i + 1))
    return t


# ----------------------------------------------------------------- phase 5

def engine_parity(gi, cfg, hap_cov, device):
    """(sites, GT mismatches, max |GPP diff|) of the torch engine against the
    host oracle on the same counts."""
    res_t = genotype_torch(gi, cfg, hap_cov, cfg.seed, device=device)
    res_n = genotype_np(gi, cfg, hap_cov, cfg.seed)
    if set(res_t) != set(res_n):
        fail("torch and np engines scored different sites")
    node_at = {(c, n.start): n for c in gi.graph.nodes for n in gi.graph.nodes[c]}

    def gt(rec, key):
        return sorted(int(node_at[key].hap_gt[h]) for h in rec.hap_vec)

    mism = sum(gt(res_t[k], k) != gt(res_n[k], k) or res_t[k].uk != res_n[k].uk
               or res_t[k].kmer_num_vec != res_n[k].kmer_num_vec for k in res_n)
    gpp = max((abs(res_t[k].probability - res_n[k].probability) for k in res_n),
              default=0.0)
    return len(res_n), mism, gpp


# ----------------------------------------------------------------- phase 6

def compare_vgt(path: str, want: str) -> int:
    """Prints and returns the number of .vgt members that differ in dtype,
    shape or value (meta compared as parsed JSON: the zip bytes carry
    timestamps)."""
    with np.load(path) as a, np.load(want) as b:
        if sorted(a.files) != sorted(b.files):
            fail(f"member sets differ: {sorted(a.files)} vs {sorted(b.files)}")
        differ = 0
        for name in a.files:
            x, y = a[name], b[name]
            if name == "meta":
                same = json.loads(bytes(x)) == json.loads(bytes(y))
            else:
                same = (x.dtype == y.dtype and x.shape == y.shape
                        and np.array_equal(x, y))
            if not same:
                print(f"  member {name} differs")
                differ += 1
        print(f"  {len(a.files) - differ} of {len(a.files)} members equal")
        return differ


def construct_timings(log_text: str) -> dict[str, float]:
    t = {}
    for name, pat in (("vcf parse", r"phase timing: vcf parse ([\d.]+)s"),
                      ("walk", r"phase timing: walk ([\d.]+)s"),
                      ("genome counts", r"phase timing: genome counts ([\d.]+)s"),
                      ("index", r"phase timing: index ([\d.]+)s"),
                      ("graph2node", r"graph2node precomputed \(([\d.]+)s\)"),
                      ("save", r"graph write complete \(([\d.]+)s\)")):
        m = re.search(pat, log_text)
        if not m:
            fail(f"no '{name}' timing in the construct log")
        t[name] = float(m.group(1))
    for m in re.finditer(r"aggregation: (.*) \(([\d.]+)s\)$", log_text, re.M):
        t["index: " + m.group(1)] = float(m.group(2))
    return t


def print_timings(t: dict[str, float], wall: float) -> None:
    for k, v in t.items():
        print(f"    {k}: {v:.2f} s")
    print(f"    CLI wall: {wall:.2f} s")


def construct(ref: str, vcf: str, out: str,
              device_name: str = "cuda") -> tuple[str, float]:
    """Runs the construct CLI on the card; returns (log, wall seconds)."""
    t0 = time.perf_counter()
    log_text = run_cli(["construct", "-r", ref, "-v", vcf, "-k", str(K),
                        "--seed", "0", "--device", device_name,
                        "--save-graph", out])
    return log_text, time.perf_counter() - t0


# ----------------------------------------------------------------- phase 7

def _genome_batch(codes: torch.Tensor):
    """Sketch one genome batch; returns its (keys, mask) as the construct
    path hands them to the filter (first k-1 columns dropped)."""
    values, emit = sketch_codes(codes, K)
    return (values[:, K - 1:].reshape(-1).contiguous(),
            emit[:, K - 1:].reshape(-1).contiguous())


def cbf_cases(device, fixture_genome: dict[str, str]):
    """(name, m, kh, [(keys, mask) adds], queries) edge cases the kernels
    must get exactly right."""
    gen = torch.Generator(device=device).manual_seed(2)
    rnd = _kmer_values(200_000, gen, device)
    ones = torch.ones(rnd.shape, dtype=torch.bool, device=device)
    m25 = 1 << 25
    yield ("random keys, 90% mask", m25, 12,
           [(rnd, torch.rand(rnd.shape, generator=gen, device=device) < 0.9)], rnd)
    k28 = _kmer_values(100_000, gen, device, span=28)
    k28[::2] |= -(1 << 63)
    yield "keys with bit 63 set", m25, 12, [(k28, ones[:k28.numel()])], k28
    yield "all masked", m25, 12, [(rnd, torch.zeros_like(ones))], rnd
    yield "N = 0", m25, 12, [(rnd[:0], ones[:0])], rnd[:0]
    one = rnd[:1].repeat(300)
    yield "one key added 300 times", m25, 12, [(one, ones[:300])], rnd[:2]
    n = sum(len(s) for s in fixture_genome.values()) - K + 1
    bf = CountingBloomFilter(n, 0.01, 0)  # the fixture's sizing (host-side)
    seq = next(iter(fixture_genome.values()))
    batch = next(build_mod.segment_genome_batches(seq, K))
    keys, mask = _genome_batch(torch.from_numpy(batch).to(device))
    yield ("one genome batch of the fixture", bf.size, bf.num_hashes,
           [(keys, mask)], keys)


def _max_abs_diff_u8(a: torch.Tensor, b: torch.Tensor) -> int:
    """max |a - b| of two uint8 tensors, without widening a 1 GiB filter."""
    if not a.numel():
        return 0
    return int((torch.maximum(a, b) - torch.minimum(a, b)).max())


def check_cbf(device, fixture_genome) -> int:
    """Kernels against plain on every case; returns the max abs difference
    of filter bytes and counts (must be 0)."""
    worst = 0
    for name, m, kh, adds, queries in cbf_cases(device, fixture_genome):
        seeds = CountingBloomFilter._seed_tensor(make_seeds(kh, 0), device)
        fa = torch.zeros(m, dtype=torch.uint8, device=device)
        fb = torch.zeros_like(fa)
        for keys, mask in adds:
            cbf_cuda.cbf_add_(fa, keys, mask, seeds)
            cbf_add_plain(fb, keys, mask, seeds)
        ca = cbf_cuda.cbf_count(fa, queries, seeds)
        cb = cbf_count_plain(fb, queries, seeds)
        torch.cuda.synchronize(device)
        err = max(int((fa.int() - fb.int()).abs().max()),
                  int((ca.int() - cb.int()).abs().max()) if ca.numel() else 0)
        print(f"  cbf case {name}: m=2^{m.bit_length() - 1} kh={kh} "
              f"N={sum(k.numel() for k, _ in adds)} nonzero={int(fa.count_nonzero())} "
              f"max count={int(ca.max()) if ca.numel() else 0} max_abs_err={err}")
        if err:
            fail(f"filter kernels disagree with plain on case '{name}'")
        if name.startswith("one key added") and ca[0].item() != 255:
            fail("a key added 300 times did not saturate at 255")
        worst = max(worst, err)
    return worst


def time_cbf(device) -> tuple[dict[str, tuple[float, float]], int]:
    """Kernel and plain ms of add and count at one genome batch's shape,
    kh = 7, at m = 2^25 and 2^30: plain, kernel, kernel, plain.  Before
    timing, holds the kernels' filter bytes and counts against plain at
    that shape; returns (times, max abs difference)."""
    gen = torch.Generator(device=device).manual_seed(3)
    codes = torch.randint(0, 4, (BATCH, READ_LEN_PAD), generator=gen,
                          device=device, dtype=torch.uint8)
    keys, mask = _genome_batch(codes)
    seeds = CountingBloomFilter._seed_tensor(make_seeds(CBF_TIMING_KH, 0), device)
    out, worst = {}, 0
    for log2m in (25, 30):
        filt = torch.zeros(1 << log2m, dtype=torch.uint8, device=device)
        ref = torch.zeros_like(filt)
        cbf_cuda.cbf_add_(filt, keys, mask, seeds)
        cbf_add_plain(ref, keys, mask, seeds)
        ca = cbf_cuda.cbf_count(filt, keys, seeds)
        cb = cbf_count_plain(ref, keys, seeds)
        err = max(_max_abs_diff_u8(filt, ref), _max_abs_diff_u8(ca, cb))
        print(f"  cbf at m=2^{log2m}, {keys.numel()} keys x kh {CBF_TIMING_KH}: "
              f"kernel vs plain max_abs_err {err}")
        if err:
            fail(f"filter kernels disagree with plain at m=2^{log2m}")
        worst = max(worst, err)
        del ref
        fns = {
            "add": (lambda: cbf_cuda.cbf_add_(filt, keys, mask, seeds),
                    lambda: cbf_add_plain(filt, keys, mask, seeds)),
            "count": (lambda: cbf_cuda.cbf_count(filt, keys, seeds),
                      lambda: cbf_count_plain(filt, keys, seeds)),
        }
        for op, (kernel, plain) in fns.items():
            p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                              time_ms(plain))
            kms, pms = min(k1, k2), min(p1, p2)
            out[f"{op} m=2^{log2m}"] = (kms, pms)
            print(f"  cbf {op} at m=2^{log2m}, {keys.numel()} keys x kh "
                  f"{CBF_TIMING_KH}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms; kernel {keys.numel() / kms / 1e3:.1f}M "
                  f"keys/s")
        del filt
    return out, worst


# ----------------------------------------------------------------- phase 8

def phase_exact(device, work: str, genome: dict[str, str]) -> tuple[dict, int]:
    """Construct in the exact-count regime; returns (launches, max abs
    difference of the kernel's counts from the plain join's)."""
    fed = []

    class Recording(ExactGenomeCounter):
        def count(self, hashes):
            counts = super().count(hashes)
            fed.append((np.array(hashes, np.uint64), counts))
            return counts

    out = os.path.join(work, "exact.vgt")
    saved = build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter
    build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter = 1, Recording
    try:
        LAUNCHES.clear()
        log_text, wall = construct(os.path.join(FIXTURE, "ref.fa.gz"),
                                   os.path.join(FIXTURE, "vars.vcf.gz"), out)
        launches = dict(LAUNCHES)
    finally:
        build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter = saved
    print(f"  launches {launches}; construct CLI wall {wall:.2f} s")
    if not launches.get("count_join") or launches.get("cbf_add"):
        fail("the exact regime did not count through the join kernel alone")
    if len(fed) != 1:
        fail(f"the exact counter was queried {len(fed)} times, not once")
    queries, counts = fed[0]
    plain = ExactGenomeCounter(genome, K, device=device,
                               join=count_join).count(queries)
    err = int(np.abs(counts.astype(np.int64) - plain.astype(np.int64)).max())
    with np.load(out) as z, np.load(os.path.join(FIXTURE, "graph.vgt")) as c:
        keys = z["tbl_keys"]
        covered = np.isin(keys, queries).all()
        print(f"  {len(queries)} candidate k-mers counted, kernel vs plain join "
              f"max_abs_err {err}; {len(keys)} table keys, all among them: "
              f"{covered}; the filter-regime table has {len(c['tbl_keys'])} keys, "
              f"{int(np.isin(keys, c['tbl_keys']).sum())} shared")
    if err or not covered:
        fail("exact genome counts differ between the join kernel and plain")
    return launches, err


# ----------------------------------------------------------------- phase 9

def make_big_inputs(work: str) -> tuple[str, str]:
    """A BIG_MB Mb genome of BIG_CHROMS chromosomes and a VCF of BIG_SITES
    sites x BIG_SAMPLES samples, from tools/gen_big.py's seeded generators
    (no reads)."""
    rng = np.random.default_rng(BIG_SEED)
    names = [f"S{i + 1}" for i in range(BIG_SAMPLES)]
    chrom_len = BIG_MB * 1_000_000 // BIG_CHROMS
    ref, vcf = os.path.join(work, "big.fa"), os.path.join(work, "big.vcf.gz")
    parts = []
    with open(ref, "w") as fh:
        for ci in range(BIG_CHROMS):
            chrom = f"chr{ci + 1}"
            genome = gen_big.make_genome(rng, chrom_len)
            text = genome.tobytes().decode()
            fh.write(f">{chrom}\n")
            for j in range(0, len(text), 10_000_000):
                fh.write(text[j:j + 10_000_000] + "\n")
            pos, ref_lens, alt_lens, gts = gen_big.make_sites(
                rng, chrom_len, BIG_SITES // BIG_CHROMS, 2 * BIG_SAMPLES)
            part = os.path.join(work, f"big_{chrom}.vcf.gz")
            gen_big.write_vcf(part, chrom, genome, pos, ref_lens, alt_lens, gts,
                              rng, names)
            parts.append(part)
    with gzip.open(vcf, "wb", compresslevel=1) as out:
        for i, part in enumerate(parts):
            with gzip.open(part, "rb") as fh:
                for line in fh:
                    if i == 0 or not line.startswith(b"#"):
                        out.write(line)
    return ref, vcf


def check_big_filter(device, ref: str, queries: torch.Tensor) -> int:
    """The kernel's filter against the plain version's after the first
    FILTER_CHECK_BATCHES genome batches, at the construct's sizing, and the
    kernel's counts of ``queries`` (the table's keys) read from it against
    the plain counts; returns the max abs difference of bytes and counts."""
    genome, _, size = read_fasta(ref)
    kern = CountingBloomFilter(size - K + 1, 0.01, 0, device=device)
    plain = torch.zeros_like(kern.filter)
    batches = (b for seq in genome.values()
               for b in build_mod.segment_genome_batches(seq, K))
    n = 0
    for batch in batches:
        keys, mask = _genome_batch(torch.from_numpy(batch).to(device))
        kern.add(keys, mask)
        cbf_add_plain(plain, keys, mask, kern.seeds_t)
        n += 1
        if n == FILTER_CHECK_BATCHES:
            break
    differ = int((kern.filter != plain).sum())
    ca = cbf_cuda.cbf_count(kern.filter, queries, kern.seeds_t)
    cb = cbf_count_plain(plain, queries, kern.seeds_t)
    err = max(_max_abs_diff_u8(kern.filter, plain), _max_abs_diff_u8(ca, cb))
    print(f"  filter m={kern.size} kh={kern.num_hashes}: kernel vs plain after "
          f"{n} genome batches, {differ} counters differ, "
          f"{int(plain.count_nonzero())} nonzero; counts of the {queries.numel()} "
          f"table keys read from it: {int((ca != cb).sum())} differ, "
          f"{int(ca.count_nonzero())} nonzero; max_abs_err {err}")
    return err


def phase_big(device, work: str):
    """Construct at BIG_MB Mb; returns (launches, the filter kernels' max
    abs difference from plain at the construct's 2^30 cells, the genome
    FASTA, the loaded graph, its .vgt path, the construct's genome filter)."""
    t0 = time.perf_counter()
    ref, vcf = make_big_inputs(work)
    print(f"  generated {BIG_MB} Mb x {BIG_CHROMS} chromosomes, {BIG_SITES} sites x "
          f"{BIG_SAMPLES} samples in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "big.vgt")
    made = []

    class Recording(CountingBloomFilter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    saved = build_mod.CountingBloomFilter
    build_mod.CountingBloomFilter = Recording
    try:
        LAUNCHES.clear()
        log_text, wall = construct(ref, vcf, out)
        launches = dict(LAUNCHES)
    finally:
        build_mod.CountingBloomFilter = saved
    if len(made) != 1:
        fail(f"the {BIG_MB} Mb construct made {len(made)} filters, not one")
    print(f"  launches {launches}")
    if not launches.get("cbf_add") or not launches.get("cbf_count"):
        fail(f"the {BIG_MB} Mb construct did not launch the filter kernels")
    m = re.search(r"Counting Bloom Filter size: (\d+)", log_text)
    if not m or int(m.group(1)) != BIG_FILTER_CELLS:
        fail(f"the {BIG_MB} Mb construct did not use a {BIG_FILTER_CELLS}-cell "
             "filter")
    print("  construct phase timings:")
    print_timings(construct_timings(log_text), wall)
    gi = load_graph(out, device=device)
    keys = gi.table.keys_np()
    freq = gi.table.freq_np()
    ok = (len(keys) > 0 and bool((keys[1:] > keys[:-1]).all())
          and bool((freq >= 1).all()) and gi.table.keys.device == device)
    print(f"  read back: {len(keys)} table keys, unique and sorted, freq >= 1: "
          f"{ok}; {gi.nhap} haplotypes; {os.path.getsize(out) / 1e6:.1f} MB file")
    if not ok:
        fail(f"the {BIG_MB} Mb table is not unique, sorted and freq >= 1")
    err = check_big_filter(device, ref, gi.table.keys)
    if err:
        fail(f"the filter kernels disagree with plain on the {BIG_MB} Mb genome")
    return launches, err, ref, gi, out, made[0]


# ---------------------------------------------------------------- phase 10

def _same_table(a, b) -> bool:
    """Every table array of two loaded graphs equal."""
    return all(np.array_equal(getattr(a.table, v)(), getattr(b.table, v)())
               for v in ("keys_np", "freq_np", "hap_words_np", "refflag_np",
                         "cov_u8"))


def _same_local_bits(a, b) -> tuple[int, int]:
    """(variant nodes whose rebuilt local bits equal the .vgt's, variant
    nodes)."""
    same = n = 0
    for chrom in a.graph.nodes:
        for x, y in zip(a.graph.nodes[chrom], b.graph.nodes[chrom]):
            if x.is_variant:
                n += 1
                same += np.array_equal(np.asarray(x.local_bits, np.uint8),
                                       np.asarray(y.local_bits, np.uint8))
    return same, n


def phase_interop(device, work: str, cfg_path: str, big_gi, big_vgt: str):
    """graph.bin on the card; returns the genotype run's launches."""
    vgt = os.path.join(FIXTURE, "graph.vgt")
    bin_path = os.path.join(work, "graph.bin")
    save_reference_graph_bin(load_graph(vgt, device=device), bin_path)
    print(f"  wrote the 2 Mb graph as graph.bin, "
          f"{os.path.getsize(bin_path) / 1e6:.1f} MB")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    vcf, _ = run_main_path(device.type, work, cfg_path,
                           os.path.join(work, "counts_bin.npz"),
                           graph=bin_path, out_name="out_bin")
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    agree, sites = gt_agreement(vcf)
    print(f"  genotype --load-graph graph.bin: launches {launches}; S1 GT "
          f"agrees with the truth at {agree}/{sites} sites "
          f"({agree / sites:.4f}); CLI wall {wall:.2f} s")
    if not launches.get("count_join") or agree < MIN_GT_AGREEMENT * sites:
        fail("genotype from graph.bin fell below 99% or skipped the join")
    a, b = load_graph(bin_path, device=device), load_graph(vgt, device=device)
    same_tbl = _same_table(a, b) and a.table.keys.device == device
    same, n = _same_local_bits(a, b)
    print(f"  graph.bin load: table arrays equal to the .vgt's: {same_tbl}; "
          f"rebuilt local bits equal to the construct-time ones at "
          f"{same}/{n} variant nodes")
    if not same_tbl:
        fail("the table loaded from graph.bin differs from the .vgt's")

    big_bin = os.path.join(work, "big.bin")
    t0 = time.perf_counter()
    save_reference_graph_bin(big_gi, big_bin)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_graph(big_bin, device=device, threads=os.cpu_count() or 1)
    t_load = time.perf_counter() - t0
    same, n = _same_local_bits(back, load_graph(big_vgt))
    ok = _same_table(back, big_gi)
    print(f"  {BIG_MB} Mb graph.bin ({os.path.getsize(big_bin) / 1e6:.1f} MB): "
          f"write {t_save:.2f} s, load {t_load:.2f} s (local bits rebuilt on "
          f"the card); table equal: {ok}; local bits equal at {same}/{n} "
          f"variant nodes")
    if not ok:
        fail(f"the {BIG_MB} Mb table loaded from graph.bin differs")
    return launches


# ---------------------------------------------------------------- phase 11

def _split_fastq(src: str, outs: list[str]) -> None:
    fhs = [open(p, "w") for p in outs]
    with open(src) as fh:
        for n, rec in enumerate(zip(*[fh] * 4)):
            fhs[n % len(fhs)].writelines(rec)
    for fh in fhs:
        fh.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _vcf_bytes(vcf: str) -> bytes:
    with gzip.open(vcf, "rb") as fh:
        return fh.read()


def phase_multiprocess(device, work: str, fq: str):
    """Two CLI processes on the card against one; returns the single
    process run's launches."""
    fqs = [os.path.join(work, f"S1_{i}.fq") for i in range(2)]
    _split_fastq(fq, fqs)
    cfg2 = os.path.join(work, "samples2.cfg")
    with open(cfg2, "w") as fh:
        fh.write("S1 " + " ".join(fqs) + "\n")
    graph = os.path.join(FIXTURE, "graph.vgt")
    LAUNCHES.clear()
    vcf1, _ = run_main_path(device.type, work, cfg2, os.path.join(work, "c1.npz"),
                            out_name="out_1proc")
    launches = dict(LAUNCHES)
    if not launches.get("count_join"):
        fail("the one-process run on two files did not launch the join")

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    out2 = os.path.join(work, "out_2proc")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "varigraph_tpu_torch", "genotype",
         "--load-graph", graph, "-s", cfg2, "--out-dir", out2,
         "--device", device.type, "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        logs = []
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=PROCESS_TIMEOUT_S)
            logs.append(err)
            if p.returncode != 0:
                fail(f"process {i} of the 2-process run exited "
                     f"{p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, text in enumerate(logs):
        m = re.search(r"kernel launches: (\{.*\})", text)
        tbl = re.search(r"\(table on (\S+)\)", text)
        print(f"  process {i}: {m.group(0) if m else 'no launch line'}; "
              f"table on {tbl.group(1) if tbl else '?'}")
        if (not m or "count_join" not in m.group(1)
                or "merged counts from 2 hosts" not in text
                or "merged scoring results from 2 hosts" not in text):
            fail(f"process {i} did not count through the join kernel and "
                 "merge with its peer")
    same = _vcf_bytes(os.path.join(out2, "S1.varigraph.vcf.gz")) == _vcf_bytes(vcf1)
    print(f"  2-process VCF byte-identical to the 1-process VCF: {same}; "
          f"2-process wall {wall:.2f} s (two interpreters, CUDA start-up "
          f"in each)")
    if not same:
        fail("the 2-process VCF differs from the 1-process VCF")
    return launches


# ---------------------------------------------------------------- phase 12

def _mesh(device) -> Mesh:
    n = torch.cuda.device_count()
    if n > 1:
        mesh = Mesh([torch.device("cuda", i) for i in range(n)])
        print(f"  mesh over the card's {n} devices: {mesh}")
    else:
        mesh = Mesh([device, device])
        print(f"  one device (device_count {n}): mesh of 2 logical shards "
              f"of {device}")
    return mesh


def check_sharded_big_filter(mesh, ref: str, single) -> tuple[int, float]:
    """Phase 9's genome filter built again over the mesh; returns (max abs
    difference from phase 9's one-device filter, seconds)."""
    genome, _, size = read_fasta(ref)
    saved = build_mod._CBF_SHARD_MIN
    build_mod._CBF_SHARD_MIN = 1
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf = build_mod.make_genome_cbf(genome, size, K, 0, single.device, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        build_mod._CBF_SHARD_MIN = saved
    if not isinstance(bf, ShardedCBF) or len(bf.shards) != mesh.size:
        fail("make_genome_cbf did not take the sharded filter")
    if (bf.size, bf.num_hashes) != (single.size, single.num_hashes):
        fail("the sharded filter is sized unlike the one-device filter")
    err = max(_max_abs_diff_u8(s.to(single.device),
                               single.filter[lo:lo + bf.m_local])
              for s, lo in zip(bf.shards, bf.los))
    print(f"  {BIG_MB} Mb genome filter over {mesh.size} shards of "
          f"{bf.m_local} cells: {secs:.2f} s; vs phase 9's one-device filter "
          f"max_abs_err {err}")
    return err, secs


def check_three_shards(device, fixture_genome) -> int:
    """A 3-shard filter on the card (m = 2^25 + 1, modulo addressing, shards
    of 11,184,811 cells) against the plain version over the same shards."""
    mesh = Mesh([device] * 3)
    n = (1 << 25) // 10     # m rounds up to 2^25, padded to a multiple of 3
    bf = ShardedCBF(n, 0.01, 0, mesh=mesh)
    plain = [torch.zeros(bf.m_local, dtype=torch.uint8, device=device)
             for _ in range(3)]
    seq = next(iter(fixture_genome.values()))
    adds = 0
    for batch in build_mod.segment_genome_batches(seq, K):
        keys, mask = _genome_batch(torch.from_numpy(batch).to(device))
        bf.add(keys, mask)
        for p, lo in zip(plain, bf.los):
            cbf_add_plain(p, keys, mask, bf.seeds_t[0], bf.size, lo)
        adds += 1
    got = torch.from_numpy(bf.count(keys))
    want = torch.stack([cbf_count_plain(p, keys, bf.seeds_t[0], bf.size, lo)
                        for p, lo in zip(plain, bf.los)]).amin(dim=0).cpu()
    err = max(max(_max_abs_diff_u8(s, p) for s, p in zip(bf.shards, plain)),
              _max_abs_diff_u8(got, want))
    print(f"  3 shards: m={bf.size} (not a power of two), {bf.m_local} cells "
          f"a shard, kh={bf.num_hashes}, {adds} genome batches; kernel vs plain "
          f"max_abs_err {err}; {int(sum(s.count_nonzero() for s in bf.shards))} "
          f"nonzero")
    if err:
        fail("the 3-shard filter kernels disagree with plain")
    return err


def time_shard(device) -> tuple[dict[str, tuple[float, float]], int]:
    """Kernel and plain ms of add and count on the second of two shards of
    SHARD_CELLS cells (m = 2 * SHARD_CELLS) at one genome batch, kh = 7:
    plain, kernel, kernel, plain, after holding the kernels against plain."""
    gen = torch.Generator(device=device).manual_seed(3)
    codes = torch.randint(0, 4, (BATCH, READ_LEN_PAD), generator=gen,
                          device=device, dtype=torch.uint8)
    keys, mask = _genome_batch(codes)
    seeds = CountingBloomFilter._seed_tensor(make_seeds(CBF_TIMING_KH, 0), device)
    m, lo = 2 * SHARD_CELLS, SHARD_CELLS
    filt = torch.zeros(SHARD_CELLS, dtype=torch.uint8, device=device)
    ref = torch.zeros_like(filt)
    cbf_cuda.cbf_add_(filt, keys, mask, seeds, m, lo)
    cbf_add_plain(ref, keys, mask, seeds, m, lo)
    err = max(_max_abs_diff_u8(filt, ref),
              _max_abs_diff_u8(cbf_cuda.cbf_count(filt, keys, seeds, m, lo),
                               cbf_count_plain(ref, keys, seeds, m, lo)))
    print(f"  shard of 2^{SHARD_CELLS.bit_length() - 1} cells from {lo} of "
          f"m=2^{m.bit_length() - 1}: kernel vs plain max_abs_err {err}")
    if err:
        fail("the per-shard kernels disagree with plain")
    del ref
    out = {}
    fns = {
        "add": (lambda: cbf_cuda.cbf_add_(filt, keys, mask, seeds, m, lo),
                lambda: cbf_add_plain(filt, keys, mask, seeds, m, lo)),
        "count": (lambda: cbf_cuda.cbf_count(filt, keys, seeds, m, lo),
                  lambda: cbf_count_plain(filt, keys, seeds, m, lo)),
    }
    for op, (kernel, plain) in fns.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        out[op] = (min(k1, k2), min(p1, p2))
        print(f"  shard {op}, {keys.numel()} keys x kh {CBF_TIMING_KH}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return out, err


def phase_mesh(device, work: str, cfg_path: str, counts: str, vcf4: str,
               ref: str, big_filter, fixture_genome):
    """The mesh phase; returns (launches of its main paths, the filter
    kernels' max abs error, the per-shard times)."""
    mesh = _mesh(device)
    launches = collections.Counter()
    err, _ = check_sharded_big_filter(mesh, ref, big_filter)
    if err:
        fail(f"the sharded {BIG_MB} Mb filter differs from the one-device one")
    err = max(err, check_three_shards(device, fixture_genome))

    # construct of the fixture over the mesh, shard threshold forced
    made = []

    class Recording(ShardedCBF):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    port_vgt = os.path.join(work, "sharded.vgt")
    saved = (build_mod._CBF_SHARD_MIN, build_mod.ShardedCBF, build_mod.make_mesh,
             pipeline_mod.make_mesh)
    build_mod._CBF_SHARD_MIN, build_mod.ShardedCBF = 1, Recording
    build_mod.make_mesh = pipeline_mod.make_mesh = lambda n, dev: mesh
    try:
        LAUNCHES.clear()
        construct(os.path.join(FIXTURE, "ref.fa.gz"),
                  os.path.join(FIXTURE, "vars.vcf.gz"), port_vgt, device.type)
        launches.update(LAUNCHES)
        print(f"  sharded construct launches {dict(LAUNCHES)}")
        if len(made) != 1 or len(made[0].shards) != mesh.size:
            fail("construct did not build its filter over the mesh")
        if LAUNCHES["cbf_add"] < mesh.size or LAUNCHES["cbf_count"] < mesh.size:
            fail("the sharded construct did not launch the filter kernels "
                 "on every shard")
        if compare_vgt(port_vgt, os.path.join(FIXTURE, "graph.vgt")):
            fail("the sharded construct differs from the committed graph")

        # genotype over the mesh: replicated counting, window-sharded fb
        LAUNCHES.clear()
        mesh_counts = os.path.join(work, "counts_mesh.npz")
        vcf, log_text = run_main_path(device.type, work, cfg_path,
                                      mesh_counts, out_name="out_mesh")
        launches.update(LAUNCHES)
    finally:
        (build_mod._CBF_SHARD_MIN, build_mod.ShardedCBF, build_mod.make_mesh,
         pipeline_mod.make_mesh) = saved
    spread = (f"counting data-parallel over {mesh.size} devices" in log_text
              and f"forward/backward over {mesh.size} devices" in log_text)
    with np.load(counts) as a, np.load(mesh_counts) as b:
        same_cov = (np.array_equal(a["cov"], b["cov"])
                    and int(a["read_base"]) == int(b["read_base"]))
    same_vcf = _vcf_bytes(vcf) == _vcf_bytes(vcf4)
    print(f"  genotype over the mesh: join launches {LAUNCHES['count_join']}; "
          f"counting and fb spread over it: {spread}; coverage equal to phase "
          f"4's: {same_cov}; VCF byte-identical to phase 4's: {same_vcf}")
    if not (LAUNCHES["count_join"] and spread and same_cov and same_vcf):
        fail("genotype over the mesh differs from one device")
    shard_times, e = time_shard(device)
    return launches, max(err, e), shard_times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch device: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    print("== 2. kernel builds (one nvcc per source, started together)")

    def timed_build(mod):
        t0 = time.perf_counter()
        mod.build()
        return os.path.relpath(mod.LIBRARY, ROOT), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for lib, secs in pool.map(timed_build, (join_cuda, cbf_cuda)):
            print(f"  built {lib} in {secs:.2f} s")

    print("== 3. join kernel against plain torch (tolerance: exactly equal "
          "integer counts)")
    gi = load_graph(os.path.join(FIXTURE, "graph.vgt"), device=device)
    err = check_join(join_cuda.count_join_, count_join, device)
    timings = {}
    gen = torch.Generator(device=device).manual_seed(1)
    big = _sorted_unique(_kmer_values(int(LARGE_TABLE_KEYS * 1.01), gen, device),
                         LARGE_TABLE_KEYS)
    if big.numel() != LARGE_TABLE_KEYS:
        fail("could not draw the large table")
    for label, keys in (("test graph", gi.table.keys), ("24M-key", big)):
        q, m = _join_case(keys, MAIN_PATH_QUERIES, 0.3, 0.9, gen)
        a = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        b = torch.zeros_like(a)
        join_cuda.count_join_(a, keys, q, m)
        count_join(b, keys, q, m)
        e = int((a - b).abs().max())
        if e:
            fail(f"join kernel disagrees with plain on the {label} table")
        err = max(err, e)
        # plain, kernel, kernel, plain: compare only within one call
        p1 = time_join(count_join, keys, q, m)
        k1 = time_join(join_cuda.count_join_, keys, q, m)
        k2 = time_join(join_cuda.count_join_, keys, q, m)
        p2 = time_join(count_join, keys, q, m)
        kms, pms = min(k1, k2), min(p1, p2)
        timings[label] = (kms, pms)
        print(f"  {label} table ({keys.numel()} keys), {q.numel()} query "
              f"slots: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms; "
              f"kernel {q.numel() / kms / 1e3:.1f}M k-mer slots/s, plain "
              f"{q.numel() / pms / 1e3:.1f}M k-mer slots/s")
    del big

    print("== 4. main path: genotype CLI on the card")
    with tempfile.TemporaryDirectory() as work:
        cfg_path, fq = simulate_reads(work)
        counts = os.path.join(work, "counts.npz")
        LAUNCHES.clear()
        t0 = time.perf_counter()
        vcf, log_text = run_main_path("cuda", work, cfg_path, counts)
        vcf4 = vcf
        wall = time.perf_counter() - t0
        main_launches = collections.Counter(LAUNCHES)
        launches = LAUNCHES["count_join"]
        m = re.search(r"Processed (\d+) batches, [\d.]+ Gb \(table on (\S+)\)",
                      log_text)
        if not m:
            fail("no 'Processed N batches' line in the log")
        nbatches, table_dev = int(m.group(1)), m.group(2)
        print(f"  join launches {launches}, batches {nbatches}, table on "
              f"{table_dev}")
        if launches == 0 or launches != nbatches:
            fail("the main path did not launch the join once per batch")
        if not table_dev.startswith("cuda"):
            fail("table.cov was not on the card")
        t = phase_timings(log_text)
        print("  phase timings (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in t.items()) + f"; CLI wall {wall:.2f}")
        agree, sites = gt_agreement(vcf)
        print(f"  S1 GT agrees with the truth at {agree}/{sites} sites "
              f"({agree / sites:.4f})")
        if agree < MIN_GT_AGREEMENT * sites:
            fail("GT agreement with the truth below 99%")

        print("== 5. parity on the card")
        gi = load_graph(os.path.join(FIXTURE, "graph.vgt"), device=device)
        graph2node(gi)
        count_reads(gi.table, [fq], gi.kmer_len, BATCH, READ_LEN_PAD,
                    join=count_join)
        plain_cov = gi.table.cov.cpu()
        read_base = load_counts(gi, counts)
        e = int((gi.table.cov.cpu() - plain_cov).abs().max())
        print(f"  coverage, kernel vs plain join on cuda: max_abs_err {e} "
              f"over {gi.table.size} keys")
        if e:
            fail("kernel and plain joins counted differently on the main path")
        err = max(err, e)
        cfg = VarigraphConfig(device="cuda")
        hap_cov = estimate_hap_coverage(
            gi.table.cov_u8(), gi.table.freq_np(), gi.table.hap_words_np(),
            gi.nhap, gi.vcf_ploidy, cfg.sample_ploidy,
            read_base / gi.genome_size, cfg.use_depth)
        n, mism, gpp = engine_parity(gi, cfg, hap_cov, device)
        print(f"  torch engine vs np oracle: {n} sites, {mism} GT/UK/NAK "
              f"mismatches, max |GPP diff| {gpp:.3g}")
        if mism or gpp > GPP_TOL:
            fail("torch engine disagrees with the np oracle")

        print("== 6. main path: construct CLI on the card, against the "
              "committed JAX-built graph")
        port_vgt = os.path.join(work, "port.vgt")
        LAUNCHES.clear()
        log_text, wall = construct(os.path.join(FIXTURE, "ref.fa.gz"),
                                   os.path.join(FIXTURE, "vars.vcf.gz"), port_vgt)
        main_launches.update(LAUNCHES)
        print(f"  launches {dict(LAUNCHES)}")
        if not LAUNCHES["cbf_add"] or not LAUNCHES["cbf_count"]:
            fail("construct did not launch the filter kernels")
        print_timings(construct_timings(log_text), wall)
        if compare_vgt(port_vgt, os.path.join(FIXTURE, "graph.vgt")):
            fail("the port-built graph differs from the committed JAX-built one")
        LAUNCHES.clear()
        vcf, _ = run_main_path("cuda", work, cfg_path,
                               os.path.join(work, "counts_port.npz"),
                               graph=port_vgt, out_name="out_port_graph")
        main_launches.update(LAUNCHES)
        agree, sites = gt_agreement(vcf)
        print(f"  genotype on the port-built graph: join launches "
              f"{LAUNCHES['count_join']}; S1 GT agrees with the truth at "
              f"{agree}/{sites} sites ({agree / sites:.4f})")
        if not LAUNCHES["count_join"] or agree < MIN_GT_AGREEMENT * sites:
            fail("genotyping the port-built graph fell below 99% or skipped "
                 "the join")

        print("== 7. filter kernels against plain torch (tolerance: exactly "
              "equal bytes and counts)")
        genome = read_fasta(os.path.join(FIXTURE, "ref.fa.gz"))[0]
        cbf_err = check_cbf(device, genome)
        cbf_times, e = time_cbf(device)
        cbf_err = max(cbf_err, e)

        print("== 8. main path: construct in the exact-count regime")
        exact_launches, e = phase_exact(device, work, genome)
        main_launches.update(exact_launches)
        err = max(err, e)

        print(f"== 9. main path: construct at {BIG_MB} Mb on the card")
        big_launches, e, big_ref, big_gi, big_vgt, big_filter = phase_big(
            device, work)
        main_launches.update(big_launches)
        cbf_err = max(cbf_err, e)

        print("== 10. main path: genotype from the reference graph.bin")
        main_launches.update(phase_interop(device, work, cfg_path, big_gi,
                                           big_vgt))
        del big_gi

        print("== 11. main path: two genotype processes on the card")
        main_launches.update(phase_multiprocess(device, work, fq))

        print("== 12. main path: the mesh")
        mesh_launches, e, shard_times = phase_mesh(
            device, work, cfg_path, counts, vcf4, big_ref, big_filter, genome)
        main_launches.update(mesh_launches)
        cbf_err = max(cbf_err, e)
        del big_filter

    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(f"  main-path launches: {dict(main_launches)}")
    kms, pms = timings["test graph"]
    source = "varigraph_tpu_torch/csrc/{}.cu"
    kernels = [{
        "name": "count_join", "route": "cuda", "source": source.format("join"),
        "replaces": "varigraph_tpu/ops/join_pallas.py:57",
        "launches": main_launches["count_join"], "max_abs_err": err,
        "ms": kms, "plain_ms": pms,
    }]
    for name, op, line in (("cbf_add", "add", 146), ("cbf_count", "count", 162)):
        kms, pms = cbf_times[f"{op} m=2^30"]
        sms, spms = shard_times[op]
        kernels.append({
            "name": name, "route": "cuda", "source": source.format("cbf"),
            "replaces": f"varigraph_tpu/ops/cbf.py:{line}",
            "launches": main_launches[name], "max_abs_err": cbf_err,
            "ms": kms, "plain_ms": pms, "shard_ms": sms, "shard_plain_ms": spms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
