#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (under $CUDA_HOME or /usr/local/cuda) and this
checkout; it imports nothing of JAX.  Phases, each of which must pass:

  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel build (csrc/join.cu with nvcc), timed;
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
     counts gives the same GT at every site with GPP within 2e-3.

Prints, before its last line, the kernels' JSON summary; its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result line, when any phase fails or no CUDA device
is present.
"""

from __future__ import annotations

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

from varigraph_tpu_torch.cli import main as cli_main
from varigraph_tpu_torch.config import VarigraphConfig
from varigraph_tpu_torch.genotype.counting import count_reads
from varigraph_tpu_torch.genotype.coverage import estimate_hap_coverage
from varigraph_tpu_torch.genotype.engine_np import genotype_np, graph2node
from varigraph_tpu_torch.genotype.engine_torch import genotype_torch
from varigraph_tpu_torch.genotype.pipeline import load_counts
from varigraph_tpu_torch.index.serialize import load_graph
from varigraph_tpu_torch.ops import join_cuda
from varigraph_tpu_torch.ops.table import count_join

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
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


def time_join(fn, keys, q, m, runs=TIMING_RUNS) -> float:
    """Median ms of one join call, timed with CUDA events."""
    cov = torch.zeros(keys.numel(), dtype=torch.int32, device=keys.device)
    fn(cov, keys, q, m)  # warm-up
    times = []
    for _ in range(runs):
        cov.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(cov, keys, q, m)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- phase 4

def read_fasta_gz(path: str) -> dict[str, str]:
    genome, name, parts = {}, None, []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    genome[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            elif line:
                parts.append(line)
    if name is not None:
        genome[name] = "".join(parts)
    return genome


def simulate_reads(workdir: str, sample: str = "S1") -> tuple[str, str]:
    """Writes reads drawn from the sample's two haplotypes of the fixture
    and a samples.cfg; returns (cfg path, FASTQ path)."""
    genome = read_fasta_gz(os.path.join(FIXTURE, "ref.fa.gz"))
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


def run_main_path(device_name: str, workdir: str, cfg: str,
                  counts: str) -> tuple[str, str]:
    """Runs the genotype CLI; returns (VCF path, its log)."""
    out_dir = os.path.join(workdir, "out")
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = cli_main(["genotype", "--load-graph",
                       os.path.join(FIXTURE, "graph.vgt"), "-s", cfg,
                       "--out-dir", out_dir, "--device", device_name,
                       "--save-counts", counts])
    if rc != 0:
        fail(f"genotype CLI returned {rc}")
    return os.path.join(out_dir, "S1.varigraph.vcf.gz"), tee.buf.getvalue()


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

    print("== 2. kernel build")
    t0 = time.perf_counter()
    join_cuda.build()
    print(f"  built {os.path.relpath(join_cuda.LIBRARY, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

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
        join_cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        vcf, log_text = run_main_path("cuda", work, cfg_path, counts)
        wall = time.perf_counter() - t0
        launches = join_cuda.LAUNCHES["count_join"]
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

    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    kms, pms = timings["test graph"]
    print(json.dumps({"kernels": [{
        "name": "count_join",
        "route": "cuda",
        "source": "varigraph_tpu_torch/csrc/join.cu",
        "replaces": "varigraph_tpu/ops/join_pallas.py:57",
        "launches": launches,
        "max_abs_err": err,
        "ms": kms,
        "plain_ms": pms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
