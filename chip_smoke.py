#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (under $CUDA_HOME or /usr/local/cuda) and this
checkout; it imports nothing of JAX.  Phases, each of which must pass:

  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel builds (csrc/join.cu, csrc/cbf.cu, csrc/fb.cu,
     csrc/sketch.cu, csrc/emit.cu, csrc/post.cu and csrc/prep.cu, one nvcc
     each, started together), timed;
  3. the counting kernels of csrc/join.cu against their plain torch
     versions on the card, exactly equal on edge cases, each at its table's
     own key directory and at skewed ones: the join (count_join_) and the
     packed-read counter (count_packed_, at k = 5, 16, 27, 28, with
     palindromic tracts and bit-63 keys); then, at the main path's batch
     shape (16384 reads x 160 bases, 2,195,456 windows) against the test
     graph's table and a 24M-key table, both exact and timed with their
     bounds: count_packed_, the old path (the torch sketch, then the join
     kernel), count_join_ on the sketch's value array, and the plain
     versions;
  4. the main path: ``varigraph_tpu_torch.cli.main(["genotype", ...,
     "--device", "cuda"])`` on the committed 2 Mb graph
     (tests/fixtures/slice2m) with 20x reads simulated from sample S1's two
     haplotypes; count_packed must have launched once per batch,
     emissions and forward_backward at least once, posterior as often as
     emissions (one launch a group), neither the torch emission body nor
     the plain ``_scan`` on the card, no window through the plain
     posterior (whose alpha and beta are host copies), every window's prep
     through hap_mass (one launch a window) and gather_rows, none through
     the host's numpy (also in phases 12 and 14), and S1's genotypes
     must agree with the VCF's truth at >= 99% of the sites; the first
     genotype of the process prints its emit seconds split into upload and
     device, and whether libcublas is mapped into the process before and
     after it;
  5. parity on the card: a recount with the plain count_packed gives the
     kernel's coverage exactly, and the host oracle engine (engine_np) on
     the same counts gives the same GT at every site with GPP within 2e-3;
  6. construct on the card: ``cli.main(["construct", ..., "--device",
     "cuda"])`` on the fixture's inputs (k = 27, seed 0) must write a .vgt
     whose every member equals the committed, JAX-built graph.vgt; the
     filter kernels and the context sketch (sketch_contexts) must have
     launched; genotyping the port-built graph
     (count_packed once per batch) must agree with the truth at >= 99% of
     the sites;
  7. the Bloom filter kernels against their plain torch versions on the
     card, filter bytes and counts exactly equal on edge cases: the key add
     and the count, and the fused genome add (cbf_add_codes) over genomes
     with N runs, Ns at row edges, (AT)n and a saturating poly-A run at
     k = 5, 16, 27, 28, at m = 2^25, 2^30 and over 3 shards of 2^25 + 1
     cells; then, timed with their bounds at kh = 7 and m = 2^25 and 2^30,
     the key add and the count of one genome batch (16384 x 134 keys), and
     the fused add over that batch's bases and over a 50 Mb chromosome,
     beside the old path (torch sketch + key add) and the plain version;
  8. the exact-count regime (``_CBF_DEVICE_MAX`` set to 1): construct must
     count its genome through count_codes (one launch a chromosome, one
     key_bitmap for the table), with no join launch and no torch sketch call, and every count it fed the
     table must equal the same counter run with the plain version on the
     card (the torch sketch, then the plain join);
  9. construct at a realistic size: a 100 Mb, 2-chromosome genome and a VCF
     of 50,000 sites x 50 samples (tools/gen_big.py's generators), a
     2^30-cell (1 GiB) filter on the card; phase times (the index's
     "context sketch + dedup" step among them), table checks, the file read
     back; the genome-count phase must launch cbf_add_codes and not the key
     add, the index the context sketch, and the whole construct must make
     no torch sketch call; its filter equal to the plain version's over the
     whole genome and to the old path (torch sketch, key add), timed beside
     it;
 9b. the same 100 Mb construct in the exact regime (``_CBF_DEVICE_MAX`` set
     to 1), the path of every genome above ~224 Mb on one card:
     count_codes once a chromosome, key_bitmap once, no torch sketch call, and every count
     equal to the plain version's on the same candidates; its genome-count
     phase seconds;
 10. the reference graph.bin: the committed 2 Mb graph written as graph.bin,
     ``genotype --load-graph graph.bin --device cuda`` through the CLI
     (count_packed once per batch, the scoring through its kernels alone,
     S1 must meet the 99% GT gate), the loaded
     table equal
     to the .vgt's, whether the rebuilt local bits equal the construct-time
     ones, and a timed graph.bin write and load of phase 9's 100 Mb graph,
     whose load must launch the context sketch and logs its seconds split
     into parse, walk, sketch and bit fill;
 11. two processes: S1's reads split into two FASTQ files, two genotype CLI
     processes on the card joined by ``--coordinator localhost:PORT
     --num-processes 2`` (each under a timeout, both killed on failure),
     each counting with count_packed once per batch of its own and
     launching emissions, whose VCF must be byte-identical to one
     process's on the same files (that one process's scoring through its
     kernels alone);
 12. the mesh: over the card's devices, or 2 logical shards of cuda:0 when
     there is one card.  Phase 9's 100 Mb genome filter built over 2 shards
     (cbf_add_codes on each) equals phase 9's one-device filter byte for
     byte; a 3-shard filter (m not a power of two) filled through add_codes
     equals its plain version; construct of the 2 Mb
     fixture with the shard threshold forced equals the committed graph.vgt
     in every member; genotype over the mesh (replicated counting,
     count_packed once per batch over the devices, the emissions kernel,
     window-sharded forward/backward through the kernel on each shard, its
     alpha and beta gathered on cuda:0 for the posterior kernel, as in phase
     4, no torch emission body or plain ``_scan`` on the card) gives phase 4's
     coverage and VCF; and the per-shard kernels are timed at 2^29 cells per
     shard;
 13. the forward/backward kernel (csrc/fb.cu) against the plain ``_scan``
     on the card, at atol 1e-6 and bit-identical over two runs on edge cases
     (P = 2, 3, 4, 8, rec and fre; S = 1, 15, 120, 253, 496, 780, 1275,
     3081; resets at the first and last node, a window of pad nodes only,
     padded states, zero distances both ways, N = 1; at S = 120 a dense
     random overlap, all class 0, all class P, classes above P, and
     distances so large that rec = norec; at S = 780 a dense overlap, whose
     lists are read from device memory; one window at the most states a
     launch takes); a window alone bit-identical to itself in a batch beside
     a window of dense overlap at S = 120 and 465; then at genome-scale
     groups (W = 256, N = 8,192, P = 2) at S = 120 and S = 465 (-n 30),
     each timed in rec and fre mode (the wrapper 7 times, its class-list
     layout alone, the plain version once) with its bound from the overlap's
     nonzero entries and the dense one, the gather's shared-memory
     wavefronts as a model predicts them from the layout (not a profiler
     reading), its largest difference from plain
     (all 256 windows at S = 120, the first 2 at S = 465) and two runs
     bit-identical; at S = 120 the window at row 37 bit-identical to the
     same window alone;
 14. genotype at full width: phase 9's 100 Mb graph (101 haplotypes, so the
     default -n 15 gives S = 120) with S1's reads at depth 10 in 2 FASTQ
     files (tools/gen_big.py's apply_hap and write_reads from phase 9's
     haplotypes) through the CLI on the card: phase and engine timings,
     launches, S1's GT agreement with the generator's truth (reported, not
     a gate), the scoring through its kernels alone (the posterior as in
     phase 4); then ``genotype_torch`` on the saved counts through the
     kernels, with the plain forward/backward routed in and with the plain
     emissions routed in must give the same GT, UK and NAK at every site,
     GPP within 2e-3, and with the plain posterior routed in (on host copies
     of its inputs) equal records, GPP too (the group's emission and
     posterior inputs are kept for phases 16 and 17);
 15. the sketch kernels of csrc/sketch.cu against their plain torch
     versions on the card, exactly equal: count_codes on N-bearing genomes
     (Ns at row edges, (AT)n, a poly-A run counting past 255, keys with bit
     63 set) at k = 5, 16, 27, 28, at each table's own key directory and at
     skewed ones; the context sketch on contexts of length 0, < k, k, 160
     and thousands with N runs and (AT)n at the same k, and, against the
     numpy sketch_ref, on contexts at the short route's tile and one window
     past it and of 50,000 and 1,000,000 bases (the long route must take
     exactly the three longest); then count_codes timed on phase 7's 50 Mb
     chromosome against phase 9's table keys and phase 3's 24M-key table,
     and on the 100 Mb genome's first chromosome against phase 9b's
     candidates (whose windows hit), beside the old path (the torch sketch,
     then the join kernel) and the plain version, with the keys hit; and the
     context sketch on phase 9's distinct contexts, with the contexts that
     took the long route, beside the plain version (the old padded torch
     batches and per-context np.unique), and the count's key bitmap on both
     tables (equal to its plain version), each with its bound;
 16. the emissions kernel (csrc/emit.cu) against its plain torch version on
     the card, at rtol 4e-6 on finite values with -inf and NaN at the same
     places, bit-identical over two runs: the edge cases of
     tests/test_torch_emit.py; phase 14's 100 Mb group (its real inputs,
     G = 100, N = 543, S = 120), with window 37 alone bit-identical to its
     row of the group; synthetic groups at S = 465 (-n 30), at P = 4 and at
     W = 2 (40 used haplotypes); each timed (medians of 7) as the bare
     kernel (50 back-to-back launches on prepared pointers), as the
     wrapper's call and as the plain version, beside its bound;
 17. the posterior kernel (csrc/post.cu) against its plain version on host
     copies of the same inputs, bit for bit (winner state, UK, NAK, CAK,
     fallback flags and probabilities), bit-identical over two runs, one
     launch a call: the card cases of tests/test_torch_posterior.py, phase
     14's 100 Mb group (its real inputs) and a synthetic group at the
     benchmark cells' shape (G = 4 windows of N = 5,854 nodes, S = 120,
     P = 2, K = 128); each timed (the wrapper's call, a median of 7) beside
     its bound and the plain version (one host run); then that group tiled
     to a full group of 256 windows on the card: the kernel timed, and the
     device bytes it reads and the peak allocated during the call;
 18. the window prep's kernels (csrc/prep.cu) against their plain versions
     on host copies, bit for bit and run to run, one launch a call, at the
     benchmark cells' group (G = 4 windows of N = 5,854 nodes, ~56 rows a
     node over 1,311,439 keys, 65 haplotypes) and at the potato panel's
     widths (332 haplotypes, two used-hap words): hap_mass over one window
     (the engine's launch) and over the group, and gather_rows, each timed
     (a median of 7) beside its bytes bound and the plain version.

Each main path runs with the launch counts set to 0 just before it and read
just after.  Prints, before its last line, the kernels' JSON summary (launches
summed over the main paths; times and bounds at the test graph's table for
the counting kernels, at m = 2^30 for the filter kernels, at the 50 Mb
chromosome and phase 9's table for count_codes, at phase 9's contexts for
the context sketch, at phase 14's group for the emissions (``ms`` the bare
kernel, ``call_ms`` the wrapper's call; the S = 465, P = 4 and W = 2 groups'
figures under ``s465``, ``p4``, ``w2``), at the cells' shape for the posterior
(phase 14's group under ``big``) and the window prep's kernels (the potato
widths under ``potato``),
and at phase 13's
S = 120 group for forward_backward, with its fre-mode, layout, nonzero share
and dense-bound figures and the S = 465 group's under ``s465``: the key add
and the count at one batch, with
the per-shard ``shard_ms``,
``shard_plain_ms`` and ``shard_bound_ms``; the fused add at a 50 Mb
chromosome, with its ``old_path_ms`` and its ``batch_*`` times; the key add
and the join launch on no main path, ``on_main_path`` says so);
its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result line, when any phase fails or no CUDA device
is present.
"""

from __future__ import annotations

import ast
import collections
import concurrent.futures
import contextlib
import gzip
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import varigraph_tpu_torch.genotype.engine_torch as engine_torch_mod
import varigraph_tpu_torch.genotype.pipeline as pipeline_mod
import varigraph_tpu_torch.index.build as build_mod
import varigraph_tpu_torch.ops.cbf as cbf_mod
import varigraph_tpu_torch.ops.kmer as kmer_mod
import varigraph_tpu_torch.ops.sketch as sketch_mod
from varigraph_tpu_torch.cli import main as cli_main
from varigraph_tpu_torch.config import VarigraphConfig
from varigraph_tpu_torch.genotype.combos import increment_vector
from varigraph_tpu_torch.genotype.counting import count_reads
from varigraph_tpu_torch.genotype.coverage import estimate_hap_coverage
from varigraph_tpu_torch.genotype.engine_np import genotype_np, graph2node
from varigraph_tpu_torch.genotype.engine_torch import genotype_torch
from varigraph_tpu_torch.genotype.pipeline import load_counts
from varigraph_tpu_torch.index.interop import save_reference_graph_bin
from varigraph_tpu_torch.index.serialize import load_graph
from varigraph_tpu_torch.io.fasta import read_fasta
from varigraph_tpu_torch.ops import (cbf_cuda, emit_cuda, fb_cuda, join_cuda,
                                     post_cuda, prep_cuda, sketch_cuda)
from varigraph_tpu_torch.ops.cbf import (GENOME_COLS, CountingBloomFilter,
                                         ShardedCBF, cbf_add_codes_plain,
                                         cbf_add_plain, cbf_count_plain,
                                         cbf_positions, genome_row_codes,
                                         genome_rows, make_seeds)
from varigraph_tpu_torch.ops.cuda_build import LAUNCHES
from varigraph_tpu_torch.ops.emit import emissions_plain
from varigraph_tpu_torch.ops.prep import PrepTables, node_rows
from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter
from varigraph_tpu_torch.ops.post import (WINNER, posterior_plain, probabilities,
                                          row_width)
from varigraph_tpu_torch.ops.kmer import (pack_codes_np, sketch_codes,
                                          sketch_packed)
from varigraph_tpu_torch.ops.sketch import (bitmap_bits, count_codes_plain,
                                            encode_contexts, key_bitmap_plain,
                                            sketch_contexts_plain)
from varigraph_tpu_torch.ops.sketch_ref import encode_bases_np, sketch_ref
from varigraph_tpu_torch.ops.table import (KmerTable, count_join, count_packed,
                                           directory_bits, directory_shift,
                                           key_directory)
from varigraph_tpu_torch.parallel.mesh import Mesh
from varigraph_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import gen_big  # noqa: E402
import test_torch_emit  # noqa: E402
import test_torch_posterior  # noqa: E402
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
CHROM_BASES = BIG_MB * 1_000_000 // BIG_CHROMS   # one chromosome of phase 9
CHROM_TIMING_RUNS = 3                          # timed runs at a chromosome
PROCESS_TIMEOUT_S = 300                        # each CLI process of phase 11
SHARD_CELLS = 1 << 29                          # per-shard timing (phase 12)
PACKED_CASE_KS = (5, 16, 27, 28)               # k of the packed edge cases
# the forward/backward kernel (phase 13): normalized alpha/beta agree with
# plain to float32 rounding (sums in another order); edge cases at (P, S),
# each in rec and fre; a genome-scale group of W windows of N nodes at S
# states (the JAX engine's bound of 8,192 nodes a window, -n 15 diploid het)
FB_ATOL = 1e-6
# S = 780: one state a thread, the lists in shared memory (device memory with
# a dense overlap); 1275 and 3081: the wide kernel, any states a thread
FB_EDGE_SHAPES = ((2, 1), (2, 15), (2, 120), (2, 253), (2, 496), (2, 780),
                  (2, 1275), (2, 3081), (3, 15), (4, 15), (8, 15))
FB_EDGE_W, FB_EDGE_N = 4, 300
FB_GROUP_W, FB_GROUP_N, FB_GROUP_S = 256, 8192, 120
# overlaps the class lists treat apart, and rec = norec, at P = 2, S = 120
FB_EDGE_VARIANTS = ("dense", "all_zero", "all_P", "above_P", "far")
# the group at -n 30 (the diploid het states of 30 haplotypes), held against
# plain on its first windows
FB_BIG_S, FB_BIG_PLAIN_W = 465, 2
FB_ROW = 37                                    # the split-invariance window
# the split invariance beside a dense window: W windows of N nodes at each S
FB_MIXED_W, FB_MIXED_N = 4, 512
FB_MAX_N = 12                  # nodes of the case at the most states a launch takes
# genotype at full width (phase 14): S1's reads of phase 9's genome
BIG_DEPTH, BIG_READ_FILES = 10.0, 2
# the emissions kernel (phase 16): finite values within rtol 4e-6 of plain
# (float32 sums of up to 128 terms in another order), -inf and NaN at the
# same places; synthetic groups of EMIT_G windows of EMIT_N nodes (the 100
# Mb group's node count); the plain version in chunks of at most
# EMIT_PLAIN_BYTES a [rows, K, S] intermediate; the window of the split check
EMIT_RTOL = 4e-6
EMIT_G, EMIT_N = 32, 543
EMIT_PLAIN_BYTES = 1 << 28
EMIT_ROW = 37
EMIT_BARE_LAUNCHES = 50                       # a bare-kernel timing's launches
# the posterior kernel (phases 14 and 17): every output equal to plain's,
# bit for bit (its float64 sums follow numpy's order); the benchmark cells'
# group: 4 windows of 23,417 / 4 sites
POST_CELL = dict(n=5854, S=120, P=2, K=128, nhap=65, gt_max=1,
                 fallback_share=0.001)
POST_FULL_G = 256                              # engine_torch._WINDOW_GROUP
# the window prep's kernels (phase 18): the cells' group (4 windows of 5,854
# scored nodes, ~56 rows a node over a table of 1,311,439 keys, 65
# haplotypes, 15 top and 16 used) and the potato panel's widths (332
# haplotypes, 60 used: two used-hap words)
PREP_CELL = dict(G=4, n=5854, M=1_311_439, nhap=65, n_used=16)
PREP_POTATO = dict(G=4, n=5854, M=1_311_439, nhap=332, n_used=60)
SKEWED_DIRECTORY_BITS = (1, 16)                # besides each table's own
# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; int32
# at 64 lanes an SM, a quarter of the data sheet's 67 TFLOP/s float32 (128
# lanes an SM, a fused multiply-add counted as two operations).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4
SECTOR = 32                                    # bytes a memory transaction moves
# Integer operations a bound counts, each 64-bit operation as two int32 ones
# and a 64-bit multiply as four: per base, rolling both registers and the
# palindrome test (7); per window, the min, the hash64 finalizer and the
# encoding (27); per looked-up value, the bucket's shift and test, ~2 search
# steps and the final compare (8); per value an occupancy bitmap rejects,
# its shift, range test, word index and bit test (4); per (key, seed),
# Murmur3 x64_128 of 8 bytes (24 and 6 multiplies).
ROLL_OPS, WINDOW_OPS, LOOKUP_OPS, BITMAP_OPS = 2 * 7, 2 * 27, 2 * 8, 2 * 4
MURMUR_OPS = 2 * 24 + 4 * 6


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
    """Kernel against plain on every case, at each table's own directory and
    at skewed ones; returns the max abs difference (must be 0)."""
    worst = 0
    for name, keys, q, m in join_cases(device):
        b = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        plain(b, keys, None, q, m)
        for bits in (directory_bits(keys.numel()), *SKEWED_DIRECTORY_BITS):
            a = torch.zeros_like(b)
            kernel(a, keys, key_directory(keys, bits), q, m)
            torch.cuda.synchronize(device)
            err = int((a - b).abs().max()) if a.numel() else 0
            print(f"  join case {name}: M={keys.numel()} Q={q.numel()} "
                  f"directory 2^{bits} hits={int(a.sum())} max_abs_err={err}")
            if err:
                fail(f"join kernel disagrees with plain on case '{name}', "
                     f"directory 2^{bits}")
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


def plain_join(cov, keys, directory, queries, mask):
    """The plain join under the kernel wrapper's signature (it needs no
    directory)."""
    count_join(cov, keys, queries, mask)


def plain_packed(cov, keys, directory, packed, k):
    """The plain packed counter under the kernel wrapper's signature."""
    count_packed(cov, keys, packed, k)


def old_path(cov, keys, directory, packed, k):
    """The read path before the packed kernel: the torch sketch, then the
    join kernel on its value array."""
    values, emit = sketch_packed(packed, k)
    join_cuda.count_join_(cov, keys, directory,
                          values[:, k - 1:].reshape(-1).contiguous(),
                          emit[:, k - 1:].reshape(-1).contiguous())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what sets it): the least time of moving nbytes through HBM and
    doing ops int32 operations, whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _sectors(byte_offsets: torch.Tensor) -> int:
    return int(torch.unique(byte_offsets // SECTOR).numel())


def lookup_bytes(keys, directory, values) -> int:
    """Bytes that looking up ``values`` must move: a sector of the directory
    at each distinct bucket, one of keys at each distinct lower bound, and
    a read and a write of the cov sector of each distinct hit."""
    m = keys.numel()
    if m == 0 or values.numel() == 0:
        return 0
    bits = (directory.numel() - 1).bit_length() - 1
    shift = directory_shift(int(keys[-1]) & ((1 << 64) - 1), bits)
    p = (values >> shift) & ((1 << (64 - shift)) - 1) if shift else values
    p = p[(p >= 0) & (p < 1 << bits)]
    flip = -(1 << 63)
    kf, vf = keys ^ flip, values ^ flip
    lb = torch.searchsorted(kf, vf).clamp_(max=m - 1)
    hit = lb[kf[lb] == vf]
    return SECTOR * (_sectors(torch.cat([p, p + 1]) * 4) + _sectors(lb * 8)
                     + 2 * _sectors(hit * 4))


def join_bound(keys, directory, queries, mask) -> tuple[float, str]:
    """The join reads each query and its mask once, then looks up the
    masked-in queries."""
    q = queries[mask]
    return bound(9 * queries.numel() + lookup_bytes(keys, directory, q),
                 LOOKUP_OPS * q.numel())


def packed_bound(keys, directory, packed, k) -> tuple[float, str]:
    """The packed counter reads each packed byte once, rolls its registers
    over every base within the rows' lengths, and hashes and looks up every
    window that emits (counted with the plain sketch)."""
    lens = packed[:, -2].long() | (packed[:, -1].long() << 8)
    bases = int(lens.clamp(max=4 * (packed.shape[1] - 2)).sum())
    values, emit = sketch_packed(packed, k)
    v = values[emit]
    return bound(packed.numel() + lookup_bytes(keys, directory, v),
                 ROLL_OPS * bases + (WINDOW_OPS + LOOKUP_OPS) * v.numel())


def cbf_bound(op, keys, mask, seeds, m, lo=0, m_local=None) -> tuple[float, str]:
    """add reads each key and its mask and hashes the masked-in keys with
    each seed, then reads and writes each distinct filter sector they
    reach; count reads each key, hashes it, reads each distinct sector and
    writes one byte a key."""
    m_local = m if m_local is None else m_local
    hashed = keys[mask] if op == "add" else keys
    pos = cbf_positions(hashed, seeds, m) - lo
    pos = pos[(pos >= 0) & (pos < m_local)]
    per_sector = 2 if op == "add" else 1
    return bound(9 * keys.numel() + per_sector * SECTOR * _sectors(pos),
                 MURMUR_OPS * hashed.numel() * seeds.numel())


def packed_cases(device):
    """(name, k, keys, packed) edge cases of the packed counter: at each k of
    PACKED_CASE_KS, rows of length 0, k - 1, k and 160, random lengths, a
    poly-A row, (AT)n over a whole row, opening a row and inside one (every
    window in the tract a palindrome at even k), and a table of the k-mers
    of every other row plus decoys, so that many windows are absent."""
    for k in PACKED_CASE_KS:
        rng = np.random.default_rng(k)
        codes = rng.integers(0, 4, (64, READ_LEN_PAD)).astype(np.uint8)
        lens = rng.integers(k, READ_LEN_PAD + 1, 64)
        lens[:4] = 0, k - 1, k, READ_LEN_PAD
        codes[4], lens[4] = 0, READ_LEN_PAD
        codes[5], lens[5] = np.tile([0, 3], READ_LEN_PAD // 2), READ_LEN_PAD
        codes[6, 30:120] = np.tile([0, 3], 45)
        codes[7, :70] = np.tile([0, 3], 35)
        packed = torch.from_numpy(pack_codes_np(codes, lens)).to(device)
        values, emit = sketch_packed(packed, k)
        decoys = ((rng.integers(0, 1 << min(2 * k, 54), 64, dtype=np.uint64)
                   << np.uint64(8)) | np.uint64(k))
        keys = _sorted_unique(torch.cat([
            values[::2][emit[::2]],
            torch.from_numpy(decoys.view(np.int64)).to(device)]))
        yield f"k = {k}", k, keys, packed


def check_packed(device) -> int:
    """The packed kernel against plain on every case, at each table's own
    directory and at skewed ones; returns the max abs difference (must be
    0)."""
    worst = 0
    for name, k, keys, packed in packed_cases(device):
        b = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        count_packed(b, keys, packed, k)
        for bits in (directory_bits(keys.numel()), *SKEWED_DIRECTORY_BITS):
            a = torch.zeros_like(b)
            join_cuda.count_packed_(a, keys, key_directory(keys, bits), packed, k)
            torch.cuda.synchronize(device)
            err = int((a - b).abs().max())
            print(f"  packed case {name}: M={keys.numel()} rows={packed.shape[0]} "
                  f"directory 2^{bits} hits={int(a.sum())} "
                  f"bit-63 keys={int((keys < 0).sum())} max_abs_err={err}")
            if err:
                fail(f"packed kernel disagrees with plain on case '{name}', "
                     f"directory 2^{bits}")
            worst = max(worst, err)
    return worst


def main_batch(genome: dict[str, str], device) -> torch.Tensor:
    """The main path's batch shape: BATCH rows of READ_LEN_PAD bases read at
    random places of the fixture genome (ambiguous bases replaced, as the
    feed splits reads there), packed and on the card."""
    rng = np.random.default_rng(READ_SEED)
    g = encode_bases_np(next(iter(genome.values())))
    start = rng.integers(0, len(g) - READ_LEN_PAD, BATCH)
    codes = g[start[:, None] + np.arange(READ_LEN_PAD)]
    codes = np.where(codes > 3, rng.integers(0, 4, codes.shape), codes)
    lens = np.full(BATCH, READ_LEN_PAD)
    return torch.from_numpy(pack_codes_np(codes.astype(np.uint8), lens)).to(device)


def phase_counting(device, gi, genome):
    """Phase 3: the counting kernels against plain, then timed at the main
    path's batch shape against the test graph's table and a 24M-key table.
    Returns (times by table, join max abs error, packed max abs error, the
    24M-key table)."""
    err_join = check_join(join_cuda.count_join_, plain_join, device)
    err_packed = check_packed(device)
    packed = main_batch(genome, device)
    values, emit = sketch_packed(packed, K)
    q = values[:, K - 1:].reshape(-1).contiguous()
    mask = emit[:, K - 1:].reshape(-1).contiguous()
    gen = torch.Generator(device=device).manual_seed(1)
    big = _sorted_unique(torch.cat([
        _kmer_values(int(LARGE_TABLE_KEYS * 1.01), gen, device), q[mask][::3]]),
        LARGE_TABLE_KEYS)
    if big.numel() != LARGE_TABLE_KEYS:
        fail("could not draw the large table")
    timings = {}
    for label, keys in (("test graph", gi.table.keys), ("24M-key", big)):
        d = key_directory(keys, directory_bits(keys.numel()))
        a = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        b, c, e = torch.zeros_like(a), torch.zeros_like(a), torch.zeros_like(a)
        join_cuda.count_packed_(a, keys, d, packed, K)
        count_packed(b, keys, packed, K)
        join_cuda.count_join_(c, keys, d, q, mask)
        count_join(e, keys, q, mask)
        ep, ej = int((a - b).abs().max()), int((c - e).abs().max())
        print(f"  {label} table ({keys.numel()} keys, directory "
              f"2^{d.numel().bit_length() - 1}): packed kernel vs plain "
              f"max_abs_err {ep}, join kernel vs plain {ej}; "
              f"{int(b.sum())} of {int(mask.sum())} windows hit")
        if ep or ej or not torch.equal(b, e):
            fail(f"the counting kernels disagree with plain on the {label} table")
        err_packed, err_join = max(err_packed, ep), max(err_join, ej)

        def timed(fn, *args):
            cov = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
            return time_ms(lambda: fn(cov, keys, d, *args), before=cov.zero_)

        # plain, kernel, kernel, plain: compare only within one call
        p1, o1, k1 = (timed(plain_packed, packed, K), timed(old_path, packed, K),
                      timed(join_cuda.count_packed_, packed, K))
        k2, o2, p2 = (timed(join_cuda.count_packed_, packed, K),
                      timed(old_path, packed, K), timed(plain_packed, packed, K))
        jp1, j1 = timed(plain_join, q, mask), timed(join_cuda.count_join_, q, mask)
        j2, jp2 = timed(join_cuda.count_join_, q, mask), timed(plain_join, q, mask)
        pb, pby = packed_bound(keys, d, packed, K)
        jb, jby = join_bound(keys, d, q, mask)
        t = timings[label] = {
            "count_packed": (min(k1, k2), min(p1, p2), pb, pby),
            "count_join": (min(j1, j2), min(jp1, jp2), jb, jby),
            "old_path": min(o1, o2)}
        print(f"  {label}, {packed.shape[0]} reads x {READ_LEN_PAD} bases, "
              f"{q.numel()} windows:\n"
              f"    count_packed kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, bound {pb:.4f} ms ({pby}); "
              f"{q.numel() / t['count_packed'][0] / 1e3:.1f}M windows/s\n"
              f"    old path (torch sketch + join kernel) {o1:.4f}/{o2:.4f} ms\n"
              f"    count_join kernel (directory) {j1:.4f}/{j2:.4f} ms, plain "
              f"{jp1:.4f}/{jp2:.4f} ms, bound {jb:.4f} ms ({jby})")
    return timings, err_join, err_packed, big


def check_counted_per_batch(log_text: str, launches, where: str) -> int:
    """Fails unless the run's read counting launched count_packed once per
    batch; returns the batch count."""
    m = re.search(r"Processed (\d+) batches", log_text)
    if not m:
        fail(f"{where}: no 'Processed N batches' line in the log")
    n = int(m.group(1))
    got = launches.get("count_packed", 0)
    if n == 0 or got != n:
        fail(f"{where}: count_packed launched {got} times for {n} batches")
    return n


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


def gt_agreement(vcf_path: str, truth=None) -> tuple[int, int]:
    """(sites agreeing, sites) against ``truth`` (default: S1's GTs in the
    fixture's VCF); a site without a record counts as 0/0 (the writer leaves
    out 0/0 calls)."""
    truth = truth_gts() if truth is None else truth
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


# the engine's line: its non-overlapped seconds by step
ENGINE_TIMING = (r"engine timing: prep ([\d.]+)s assemble ([\d.]+)s emit ([\d.]+)s "
                 r"fb ([\d.]+)s posterior ([\d.]+)s \(non-overlapped\)")


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
    m = re.search(ENGINE_TIMING, log_text)
    if not m:
        fail("no engine timing in the log")
    for i, name in enumerate(("prep", "assemble", "emit", "fb", "posterior")):
        t[name] = float(m.group(i + 1))
    return t


@contextlib.contextmanager
def counted_plain():
    """Counts, by (name, device type), the calls of the plain ``_scan`` and
    of the torch emission body ``_emissions_body`` while it is open."""
    calls = collections.Counter()
    saved = {name: getattr(engine_torch_mod, name)
             for name in ("_scan", "_emissions_body")}

    def counted(name, fn):
        def call(first, *a, **kw):
            calls[name, first.device.type] += 1
            return fn(first, *a, **kw)
        return call

    for name, fn in saved.items():
        setattr(engine_torch_mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(engine_torch_mod, name, fn)


@contextlib.contextmanager
def counted_torch_sketches():
    """Counts, by name, the calls of the torch ``sketch_codes`` and of the
    plain versions of the genome and context sketches while it is open,
    through every module of the port that names them."""
    calls = collections.Counter()
    originals = {"sketch_codes": kmer_mod.sketch_codes,
                 "count_codes_plain": sketch_mod.count_codes_plain,
                 "sketch_contexts_plain": sketch_mod.sketch_contexts_plain,
                 "cbf_add_codes_plain": cbf_mod.cbf_add_codes_plain}
    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("varigraph_tpu_torch."):
            continue
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                def counted(*a, _fn=fn, _name=name, **kw):
                    calls[_name] += 1
                    return _fn(*a, **kw)
                setattr(mod, name, counted)
                patched.append((mod, name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def cublas_mapped() -> bool:
    """Whether a cuBLAS library is mapped into this process."""
    with open("/proc/self/maps") as fh:
        return "libcublas" in fh.read()


def check_posterior_on_card(launches, moved, where: str) -> None:
    """Fails unless the posterior launched its kernel once for each
    emissions launch (one a group) and every window's alpha and beta stayed
    on the card: records from the kernel's rows, and no window through the
    plain posterior, which reads host copies."""
    n_post, n_emit = launches.get("posterior", 0), launches.get("emissions", 0)
    print(f"  {where}: posterior launches {n_post}, emissions launches {n_emit}; "
          f"nodes from the card's rows {moved.get('post.card_nodes', 0)}, "
          f"string-keyed from copied chains {moved.get('post.fallback_nodes', 0)}; "
          f"windows through the plain posterior {moved.get('post.plain_windows', 0)}")
    if (n_post < 1 or n_post != n_emit or not moved.get("post.card_nodes", 0)
            or moved.get("post.plain_windows", 0)):
        fail(f"{where}: the posterior did not run on the card alone, once a "
             f"group")


def check_prep_on_card(launches, moved, where: str) -> None:
    """Fails unless every window's prep went through its kernels: a mass
    launch a window (``prep.card_windows``), a gather launch a group (the
    posterior's launches: one a group in these runs, whose groups each take
    one emissions launch, as ``check_posterior_on_card`` holds), and no
    window through the plain versions."""
    n_mass, n_gather = launches.get("hap_mass", 0), launches.get("gather_rows", 0)
    n_card = moved.get("prep.card_windows", 0)
    n_groups = launches.get("posterior", 0)
    print(f"  {where}: hap_mass launches {n_mass}, gather_rows launches "
          f"{n_gather} (groups {n_groups}); windows prepped on the card "
          f"{n_card}, by the plain versions {moved.get('prep.plain_windows', 0)}")
    if (n_mass < 1 or n_gather < 1 or n_mass != n_card or n_gather != n_groups
            or moved.get("prep.plain_windows", 0)):
        fail(f"{where}: the window prep did not run on the card alone")


def check_scoring_on_card(launches, calls, where: str) -> None:
    """Fails unless the run's emissions and forward/backward launched their
    kernels and never ran the torch emission body or the plain ``_scan`` on
    the card."""
    print(f"  {where}: emissions launches {launches.get('emissions', 0)}, "
          f"forward_backward launches {launches.get('forward_backward', 0)}; "
          f"on the card, torch emission body calls "
          f"{calls['_emissions_body', 'cuda']}, plain _scan calls "
          f"{calls['_scan', 'cuda']}")
    if (launches.get("emissions", 0) < 1 or launches.get("forward_backward", 0) < 1
            or calls["_emissions_body", "cuda"] or calls["_scan", "cuda"]):
        fail(f"{where}: the scoring did not go through its kernels alone")


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
    codes = torch.from_numpy(
        encode_bases_np(next(iter(fixture_genome.values())))).to(device)
    keys, mask = _genome_batch(genome_row_codes(
        codes, K, 0, min(BATCH, genome_rows(codes.numel(), K))))
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


def edge_genome(k: int) -> dict[str, np.ndarray]:
    """Two chromosomes of base codes with the cases the genome count must
    get right: single Ns and an N run longer than k; Ns at a row's first
    base, at its last base and in the k - 1 columns two rows share; an
    (AT)n tract; a 2,000-base poly-A run (saturates); a chromosome that
    ends in an N run."""
    rng = np.random.default_rng(k)
    step = GENOME_COLS - (k - 1)
    c1 = rng.integers(0, 4, 12_000).astype(np.uint8)
    c1[500] = 4
    c1[900:900 + 2 * k + 3] = 4
    c1[3 * step] = 4
    c1[4 * step + GENOME_COLS - 1] = 4
    c1[7 * step + (k - 1) // 2] = 4
    c1[8 * step:8 * step + 2] = 4
    c1[2000:2200] = np.tile([0, 3], 100)
    c1[3000:5000] = 0
    c2 = rng.integers(0, 4, 700).astype(np.uint8)
    c2[650:] = 4
    return {"c1": c1, "c2": c2}


def _shard_filter(m_local: int, device) -> torch.Tensor:
    """A shard of m_local cells whose storage ends on a whole 32-bit word."""
    return torch.zeros(-(-m_local // 4) * 4, dtype=torch.uint8,
                       device=device)[:m_local]


def check_add_codes(device) -> int:
    """cbf_add_codes_ against its plain version on the edge genomes at
    k = 5, 16, 27, 28: over a whole filter of 2^25 and of 2^30 cells and
    over each shard of a 3-shard filter of 2^25 + 1 cells (not a power of
    two); returns the max abs difference of filter bytes (must be 0)."""
    worst = 0
    m3 = (1 << 25) + 1
    for k in PACKED_CASE_KS:
        genome = {c: torch.from_numpy(v).to(device)
                  for c, v in edge_genome(k).items()}
        seeds = CountingBloomFilter._seed_tensor(make_seeds(CBF_TIMING_KH, k),
                                                 device)
        layouts = [("m=2^25", 1 << 25, [(0, 1 << 25)]),
                   ("m=2^30", 1 << 30, [(0, 1 << 30)]),
                   ("3 shards of m=2^25+1", m3,
                    [(i * m3 // 3, m3 // 3) for i in range(3)])]
        for label, m, shards in layouts:
            err = 0
            for lo, m_local in shards:
                fa = _shard_filter(m_local, device)
                fb = torch.zeros(m_local, dtype=torch.uint8, device=device)
                for codes in genome.values():
                    cbf_cuda.cbf_add_codes_(fa, codes, k, seeds, m, lo)
                    cbf_add_codes_plain(fb, codes, k, seeds, m, lo)
                torch.cuda.synchronize(device)
                err = max(err, _max_abs_diff_u8(fa, fb))
                top = int(fb.max())
            print(f"  add_codes k={k} {label}: kernel vs plain max_abs_err "
                  f"{err}; last shard's max counter {top}")
            if err:
                fail(f"cbf_add_codes disagrees with plain at k={k}, {label}")
            worst = max(worst, err)
    return worst


def codes_bound(codes: torch.Tensor, k: int, seeds: torch.Tensor,
                m: int) -> tuple[float, str]:
    """The fused add reads each base code once, rolls its registers over
    each base of each row, hashes each emitted window with each seed, and
    reads and writes each distinct filter sector it reaches (counted with
    the plain sketch, a batch of rows at a time)."""
    rows = genome_rows(codes.numel(), k)
    step = GENOME_COLS - (k - 1)
    reached = torch.zeros(-(-m // SECTOR), dtype=torch.bool, device=codes.device)
    windows = 0
    for r0 in range(0, rows, BATCH):
        r1 = min(rows, r0 + BATCH)
        values, emit = sketch_codes(genome_row_codes(codes, k, r0, r1), k)
        v = values[emit]
        windows += v.numel()
        reached[cbf_positions(v, seeds, m).reshape(-1) // SECTOR] = True
    bases = sum(min(GENOME_COLS, codes.numel() - r * step) for r in range(rows))
    return bound(codes.numel() + 2 * SECTOR * int(reached.count_nonzero()),
                 ROLL_OPS * bases + (WINDOW_OPS + MURMUR_OPS * seeds.numel())
                 * windows)


def old_genome_path(filt, codes, k, seeds):
    """construct's genome count before the fused kernel: rows of a batch
    through the torch sketch, then the key add."""
    rows = genome_rows(codes.numel(), k)
    for r0 in range(0, rows, BATCH):
        keys, mask = _genome_batch(genome_row_codes(codes, k, r0,
                                                    min(rows, r0 + BATCH)))
        cbf_cuda.cbf_add_(filt, keys, mask, seeds)


def time_cbf(device) -> tuple[dict[str, tuple], int]:
    """Kernel and plain ms of add and count at one genome batch's shape,
    kh = 7, at m = 2^25 and 2^30; then the fused add over that batch's bases
    (16384 rows) and over a 50 Mb chromosome, beside the old path (torch
    sketch + key add) and its plain version: plain, kernel, kernel, plain.
    Before timing, holds each kernel against plain at that shape; returns
    (times, max abs difference)."""
    gen = torch.Generator(device=device).manual_seed(3)
    chrom = torch.randint(0, 4, (CHROM_BASES,), generator=gen, device=device,
                          dtype=torch.uint8)
    spans = {"batch": chrom[:(BATCH - 1) * (GENOME_COLS - K + 1) + GENOME_COLS],
             "chromosome": chrom}
    keys, mask = _genome_batch(genome_row_codes(chrom, K, 0, BATCH))
    seeds = CountingBloomFilter._seed_tensor(make_seeds(CBF_TIMING_KH, 0), device)
    out, worst = {}, 0
    for log2m in (25, 30):
        m = 1 << log2m
        filt = torch.zeros(m, dtype=torch.uint8, device=device)
        ref = torch.zeros_like(filt)
        cbf_cuda.cbf_add_(filt, keys, mask, seeds)
        cbf_add_plain(ref, keys, mask, seeds)
        ca = cbf_cuda.cbf_count(filt, keys, seeds)
        cb = cbf_count_plain(ref, keys, seeds)
        err = max(_max_abs_diff_u8(filt, ref), _max_abs_diff_u8(ca, cb))
        for span, codes in spans.items():
            filt.zero_()
            ref.zero_()
            cbf_cuda.cbf_add_codes_(filt, codes, K, seeds)
            cbf_add_codes_plain(ref, codes, K, seeds)
            err = max(err, _max_abs_diff_u8(filt, ref))
        print(f"  cbf at m=2^{log2m}, {keys.numel()} keys x kh {CBF_TIMING_KH}"
              f" and the fused add over {CHROM_BASES} bases: kernels vs plain "
              f"max_abs_err {err}")
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
            bms, by = cbf_bound(op, keys, mask, seeds, m)
            out[f"{op} m=2^{log2m}"] = (kms, pms, bms, by)
            print(f"  cbf {op} at m=2^{log2m}, {keys.numel()} keys x kh "
                  f"{CBF_TIMING_KH}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, bound {bms:.4f} ms ({by}); kernel "
                  f"{keys.numel() / kms / 1e3:.1f}M keys/s")
        for span, codes in spans.items():
            runs = TIMING_RUNS if span == "batch" else CHROM_TIMING_RUNS

            def timed(fn):
                return time_ms(lambda: fn(filt, codes, K, seeds),
                               before=filt.zero_, runs=runs)

            p1, o1, k1 = (timed(cbf_add_codes_plain), timed(old_genome_path),
                          timed(cbf_cuda.cbf_add_codes_))
            k2, o2, p2 = (timed(cbf_cuda.cbf_add_codes_), timed(old_genome_path),
                          timed(cbf_add_codes_plain))
            bms, by = codes_bound(codes, K, seeds, m)
            out[f"add_codes {span} m=2^{log2m}"] = (
                min(k1, k2), min(p1, p2), bms, by, min(o1, o2))
            print(f"  cbf add_codes at m=2^{log2m}, {span} of {codes.numel()} "
                  f"bases: kernel {k1:.4f}/{k2:.4f} ms, old path (torch sketch "
                  f"+ key add) {o1:.4f}/{o2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
                  f"ms, bound {bms:.4f} ms ({by})")
        del filt
    return out, worst


# ----------------------------------------------------------------- phase 8

def plain_count_codes(cov, keys, directory, bitmap, codes, k):
    """The plain exact count under the kernel wrapper's signature (it needs
    no directory and no bitmap)."""
    count_codes_plain(cov, keys, codes, k)


def exact_construct(ref: str, vcf: str, out: str, chroms: int, where: str):
    """Construct in the exact-count regime (``_CBF_DEVICE_MAX`` set to 1);
    fails unless the genome went through count_codes once a chromosome,
    behind one key bitmap, with no join or filter launch, the contexts through sketch_contexts,
    and no torch sketch call anywhere.  Returns (launches, log, wall
    seconds, the queried candidates, their counts)."""
    fed = []

    class Recording(ExactGenomeCounter):
        def count(self, hashes):
            counts = super().count(hashes)
            fed.append((np.array(hashes, np.uint64), counts))
            return counts

    saved = build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter
    build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter = 1, Recording
    try:
        with counted_torch_sketches() as sketches:
            LAUNCHES.clear()
            log_text, wall = construct(ref, vcf, out)
            launches = dict(LAUNCHES)
    finally:
        build_mod._CBF_DEVICE_MAX, build_mod.ExactGenomeCounter = saved
    print(f"  {where}: launches {launches}; torch sketch calls "
          f"{dict(sketches)}; construct CLI wall {wall:.2f} s")
    if (launches.get("count_codes") != chroms or launches.get("key_bitmap") != 1
            or launches.get("count_join")
            or launches.get("cbf_add") or launches.get("cbf_add_codes")
            or not launches.get("sketch_contexts") or sum(sketches.values())):
        fail(f"{where}: the exact regime did not count through count_codes "
             "once a chromosome behind one bitmap and sketch its contexts on "
             "the card alone")
    if len(fed) != 1:
        fail(f"{where}: the exact counter was queried {len(fed)} times, not once")
    return launches, log_text, wall, fed[0][0], fed[0][1]


def phase_exact(device, work: str, genome: dict[str, str]) -> tuple[dict, int]:
    """Construct in the exact-count regime; returns (launches, max abs
    difference of the kernel's counts from the plain version's)."""
    out = os.path.join(work, "exact.vgt")
    launches, _, _, queries, counts = exact_construct(
        os.path.join(FIXTURE, "ref.fa.gz"), os.path.join(FIXTURE, "vars.vcf.gz"),
        out, len(genome), "the 2 Mb exact regime")
    plain = ExactGenomeCounter(genome, K, device=device,
                               count=plain_count_codes).count(queries)
    err = int(np.abs(counts.astype(np.int64) - plain.astype(np.int64)).max())
    with np.load(out) as z, np.load(os.path.join(FIXTURE, "graph.vgt")) as c:
        keys = z["tbl_keys"]
        covered = np.isin(keys, queries).all()
        print(f"  {len(queries)} candidate k-mers counted, kernel vs plain "
              f"max_abs_err {err}; {len(keys)} table keys, all among them: "
              f"{covered}; the filter-regime table has {len(c['tbl_keys'])} keys, "
              f"{int(np.isin(keys, c['tbl_keys']).sum())} shared")
    if err or not covered:
        fail("exact genome counts differ between count_codes and plain")
    return launches, err


# ----------------------------------------------------------------- phase 9

def make_big_inputs(work: str):
    """A BIG_MB Mb genome of BIG_CHROMS chromosomes and a VCF of BIG_SITES
    sites x BIG_SAMPLES samples, from tools/gen_big.py's seeded generators;
    returns (FASTA, VCF, S1's haplotype sequences, S1's GT at each site as
    {(chrom, pos): sorted alleles})."""
    rng = np.random.default_rng(BIG_SEED)
    names = [f"S{i + 1}" for i in range(BIG_SAMPLES)]
    chrom_len = BIG_MB * 1_000_000 // BIG_CHROMS
    ref, vcf = os.path.join(work, "big.fa"), os.path.join(work, "big.vcf.gz")
    parts, haps, truth = [], [], {}
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
            _, alt_strs = gen_big.write_vcf(part, chrom, genome, pos, ref_lens,
                                            alt_lens, gts, rng, names)
            parts.append(part)
            haps += [gen_big.apply_hap(genome, pos, ref_lens, alt_strs, gts[:, h])
                     for h in (0, 1)]
            truth.update({(chrom, int(p)): sorted(int(g) for g in gts[i, :2])
                          for i, p in enumerate(pos)})
    with gzip.open(vcf, "wb", compresslevel=1) as out:
        for i, part in enumerate(parts):
            with gzip.open(part, "rb") as fh:
                for line in fh:
                    if i == 0 or not line.startswith(b"#"):
                        out.write(line)
    return ref, vcf, haps, truth


def check_big_filter(device, ref: str, queries: torch.Tensor, bf,
                     genome_secs: float) -> int:
    """The construct's genome filter (the fused kernel) against the plain
    version over the whole genome and against the old path (rows of a batch
    through the torch sketch, then the key add), timed beside the
    construct's genome-count phase; the kernel's counts of ``queries`` (the
    table's keys) against the plain counts.  Returns the max abs difference
    of bytes and counts."""
    genome, _, _ = read_fasta(ref)
    chroms = [torch.from_numpy(encode_bases_np(seq)).to(device)
              for seq in genome.values()]
    plain = torch.zeros_like(bf.filter)
    for codes in chroms:
        cbf_add_codes_plain(plain, codes, K, bf.seeds_t)
    old = torch.zeros_like(bf.filter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for codes in chroms:
        old_genome_path(old, codes, K, bf.seeds_t)
    torch.cuda.synchronize()
    old_secs = time.perf_counter() - t0
    differ = int((bf.filter != plain).sum())
    ca = cbf_cuda.cbf_count(bf.filter, queries, bf.seeds_t)
    cb = cbf_count_plain(plain, queries, bf.seeds_t)
    err = max(_max_abs_diff_u8(bf.filter, plain), _max_abs_diff_u8(ca, cb),
              _max_abs_diff_u8(bf.filter, old))
    print(f"  filter m={bf.size} kh={bf.num_hashes}: kernel vs plain over the "
          f"whole genome, {differ} counters differ, {int(plain.count_nonzero())} "
          f"nonzero; the old path (torch sketch, key add) gives the same "
          f"filter: {torch.equal(bf.filter, old)}; counts of the "
          f"{queries.numel()} table keys read from it: {int((ca != cb).sum())} "
          f"differ, {int(ca.count_nonzero())} nonzero; max_abs_err {err}")
    print(f"  genome-count phase: {genome_secs:.2f} s (construct log); the old "
          f"path's sketch and adds over the same genome {old_secs:.2f} s (host "
          f"clock, this run; without its host segmentation and copies)")
    return err


def phase_big(device, work: str):
    """Construct at BIG_MB Mb; returns (launches, the filter kernels' max
    abs difference from plain at the construct's 2^30 cells, the genome
    FASTA and VCF, the loaded graph, its .vgt path, the construct's genome
    filter, S1's haplotype sequences, S1's truth, the distinct contexts the
    index sketched)."""
    t0 = time.perf_counter()
    ref, vcf, haps, truth = make_big_inputs(work)
    print(f"  generated {BIG_MB} Mb x {BIG_CHROMS} chromosomes, {BIG_SITES} sites x "
          f"{BIG_SAMPLES} samples in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "big.vgt")
    made, phase, contexts = [], {}, []

    class Recording(CountingBloomFilter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def genome_counts(*a, **kw):
        before = collections.Counter(LAUNCHES)
        bf = saved[1](*a, **kw)
        phase["launches"] = collections.Counter(LAUNCHES) - before
        return bf

    def recorded_csr(ctxs, *a, **kw):
        contexts.append(ctxs)
        return saved[2](ctxs, *a, **kw)

    saved = (build_mod.CountingBloomFilter, build_mod.make_genome_cbf,
             build_mod.context_csr)
    (build_mod.CountingBloomFilter, build_mod.make_genome_cbf,
     build_mod.context_csr) = Recording, genome_counts, recorded_csr
    try:
        with counted_torch_sketches() as sketches:
            LAUNCHES.clear()
            log_text, wall = construct(ref, vcf, out)
            launches = dict(LAUNCHES)
    finally:
        (build_mod.CountingBloomFilter, build_mod.make_genome_cbf,
         build_mod.context_csr) = saved
    if len(made) != 1 or len(contexts) != 1:
        fail(f"the {BIG_MB} Mb construct made {len(made)} filters and "
             f"{len(contexts)} context sketches, not one each")
    print(f"  launches {launches}; in the genome-count phase "
          f"{dict(phase['launches'])}; torch sketch calls in the whole "
          f"construct {dict(sketches)}")
    if (not phase["launches"]["cbf_add_codes"] or phase["launches"]["cbf_add"]
            or not launches.get("sketch_contexts") or sum(sketches.values())):
        fail("the construct did not count its genome through cbf_add_codes "
             "and sketch its contexts on the card alone")
    if not launches.get("cbf_count"):
        fail(f"the {BIG_MB} Mb construct did not launch cbf_count")
    m = re.search(r"Counting Bloom Filter size: (\d+)", log_text)
    if not m or int(m.group(1)) != BIG_FILTER_CELLS:
        fail(f"the {BIG_MB} Mb construct did not use a {BIG_FILTER_CELLS}-cell "
             "filter")
    print("  construct phase timings:")
    timings = construct_timings(log_text)
    print_timings(timings, wall)
    m = re.search(r"aggregation: (context sketch \+ dedup .*)$", log_text, re.M)
    print(f"  {len(contexts[0])} distinct contexts of "
          f"{sum(map(len, contexts[0]))} bases; the index's step: "
          f"{m.group(1) if m else 'missing'}")
    if not m:
        fail("no 'context sketch + dedup' step in the construct log")
    gi = load_graph(out, device=device)
    keys = gi.table.keys_np()
    freq = gi.table.freq_np()
    ok = (len(keys) > 0 and bool((keys[1:] > keys[:-1]).all())
          and bool((freq >= 1).all()) and gi.table.keys.device == device)
    print(f"  read back: {len(keys)} table keys, unique and sorted, freq >= 1: "
          f"{ok}; {gi.nhap} haplotypes; {os.path.getsize(out) / 1e6:.1f} MB file")
    if not ok:
        fail(f"the {BIG_MB} Mb table is not unique, sorted and freq >= 1")
    err = check_big_filter(device, ref, gi.table.keys, made[0],
                           timings["genome counts"])
    if err:
        fail(f"the filter kernels disagree with plain on the {BIG_MB} Mb genome")
    return launches, err, ref, vcf, gi, out, made[0], haps, truth, contexts[0]


def phase_big_exact(device, work: str, ref: str, vcf: str, filter_keys: int):
    """Phase 9's construct in the exact regime; returns (launches, max abs
    difference of its counts from the plain version's on the same
    candidates, the candidates as sorted keys on the card, the genome's
    first chromosome's codes on the card).  The exact count runs when the
    index queries it, so its seconds are the index's "genome k-mer
    frequencies" step."""
    out = os.path.join(work, "big_exact.vgt")
    launches, log_text, wall, queries, counts = exact_construct(
        ref, vcf, out, BIG_CHROMS, f"the {BIG_MB} Mb exact regime")
    print("  construct phase timings:")
    timings = construct_timings(log_text)
    print_timings(timings, wall)
    genome = read_fasta(ref)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ExactGenomeCounter(genome, K, device=device,
                               count=plain_count_codes).count(queries)
    plain_s = time.perf_counter() - t0
    err = int(np.abs(counts.astype(np.int64) - plain.astype(np.int64)).max())
    with np.load(out) as z:
        n_keys = len(z["tbl_keys"])
    print(f"  {len(queries)} candidate k-mers counted, {int((counts > 0).sum())} "
          f"present in the genome, {int((counts == 255).sum())} at the cap; "
          f"count_codes vs the plain version (torch sketch, plain join) "
          f"max_abs_err {err}; the genome count (the index's genome k-mer "
          f"frequencies step) {timings['index: genome k-mer frequencies']:.2f} "
          f"s, the plain count of the same candidates {plain_s:.2f} s (host "
          f"clock); {n_keys} table keys (the filter regime's: {filter_keys})")
    if err:
        fail(f"the {BIG_MB} Mb exact counts differ between count_codes and plain")
    keys = torch.from_numpy(np.unique(queries).view(np.int64)).to(device)
    chrom = torch.from_numpy(encode_bases_np(next(iter(genome.values())))).to(device)
    return launches, err, keys, chrom


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
    with counted_plain() as calls:
        t0 = time.perf_counter()
        vcf, log_text = run_main_path(device.type, work, cfg_path,
                                      os.path.join(work, "counts_bin.npz"),
                                      graph=bin_path, out_name="out_bin")
        wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check_counted_per_batch(log_text, launches, "genotype from graph.bin")
    check_scoring_on_card(launches, calls, "genotype from graph.bin")
    agree, sites = gt_agreement(vcf)
    print(f"  genotype --load-graph graph.bin: launches {launches}; S1 GT "
          f"agrees with the truth at {agree}/{sites} sites "
          f"({agree / sites:.4f}); CLI wall {wall:.2f} s")
    if agree < MIN_GT_AGREEMENT * sites:
        fail("genotype from graph.bin fell below 99%")
    a, b = load_graph(bin_path, device=device), load_graph(vgt, device=device)
    same_tbl = _same_table(a, b) and a.table.keys.device == device
    same, n = _same_local_bits(a, b)
    print(f"  graph.bin load: table arrays equal to the .vgt's: {same_tbl}; "
          f"rebuilt local bits equal to the construct-time ones at "
          f"{same}/{n} variant nodes")
    if not same_tbl:
        fail("the table loaded from graph.bin differs from the .vgt's")

    if not launches.get("sketch_contexts"):
        fail("the graph.bin load did not sketch its contexts on the card")
    big_bin = os.path.join(work, "big.bin")
    t0 = time.perf_counter()
    save_reference_graph_bin(big_gi, big_bin)
    t_save = time.perf_counter() - t0
    tee = _Tee(sys.stderr)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with counted_torch_sketches() as sketches, contextlib.redirect_stderr(tee):
        back = load_graph(big_bin, device=device, threads=os.cpu_count() or 1)
    t_load = time.perf_counter() - t0
    load_launches = dict(LAUNCHES)
    split = re.search(r"graph\.bin load timing: (.*)$", tee.buf.getvalue(), re.M)
    same, n = _same_local_bits(back, load_graph(big_vgt))
    ok = _same_table(back, big_gi)
    print(f"  {BIG_MB} Mb graph.bin ({os.path.getsize(big_bin) / 1e6:.1f} MB): "
          f"write {t_save:.2f} s, load {t_load:.2f} s (local bits rebuilt on "
          f"the card; {split.group(1) if split else 'no split logged'}); "
          f"launches {load_launches}, torch sketch calls {dict(sketches)}; "
          f"table equal: {ok}; local bits equal at {same}/{n} variant nodes")
    if not ok:
        fail(f"the {BIG_MB} Mb table loaded from graph.bin differs")
    if (not split or not load_launches.get("sketch_contexts")
            or sum(sketches.values())):
        fail(f"the {BIG_MB} Mb graph.bin load did not sketch its contexts "
             "through the kernel alone, or logged no time split")
    return collections.Counter(launches) + collections.Counter(load_launches)


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
    with counted_plain() as calls:
        vcf1, log_text = run_main_path(device.type, work, cfg2,
                                       os.path.join(work, "c1.npz"),
                                       out_name="out_1proc")
    launches = dict(LAUNCHES)
    check_counted_per_batch(log_text, launches, "the one-process run")
    check_scoring_on_card(launches, calls, "the one-process run")

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
        if not m:
            fail(f"process {i} logged no kernel launches")
        proc_launches = ast.literal_eval(m.group(1))
        check_counted_per_batch(text, proc_launches, f"process {i} of 2")
        if not proc_launches.get("emissions"):
            fail(f"process {i} of 2 did not launch the emissions kernel")
        if ("merged counts from 2 hosts" not in text
                or "merged scoring results from 2 hosts" not in text):
            fail(f"process {i} did not merge with its peer")
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


def check_sharded_big_filter(mesh, ref: str, single) -> tuple[int, float, dict]:
    """Phase 9's genome filter built again over the mesh, through
    cbf_add_codes on every shard; returns (max abs difference from phase 9's
    one-device filter, seconds, launches)."""
    genome, _, size = read_fasta(ref)
    saved = build_mod._CBF_SHARD_MIN
    build_mod._CBF_SHARD_MIN = 1
    try:
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        bf = build_mod.make_genome_cbf(genome, size, K, 0, single.device, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        build_mod._CBF_SHARD_MIN = saved
    if not isinstance(bf, ShardedCBF) or len(bf.shards) != mesh.size:
        fail("make_genome_cbf did not take the sharded filter")
    if launches.get("cbf_add_codes", 0) < mesh.size * len(genome) or launches.get("cbf_add"):
        fail(f"the sharded genome filter did not go through cbf_add_codes "
             f"alone: {launches}")
    if (bf.size, bf.num_hashes) != (single.size, single.num_hashes):
        fail("the sharded filter is sized unlike the one-device filter")
    err = max(_max_abs_diff_u8(s.to(single.device),
                               single.filter[lo:lo + bf.m_local])
              for s, lo in zip(bf.shards, bf.los))
    print(f"  {BIG_MB} Mb genome filter over {mesh.size} shards of "
          f"{bf.m_local} cells: {secs:.2f} s, launches {launches}; vs phase "
          f"9's one-device filter max_abs_err {err}")
    return err, secs, launches


def check_three_shards(device, fixture_genome) -> int:
    """A 3-shard filter on the card (m = 2^25 + 1, modulo addressing, shards
    of 11,184,811 cells) filled through add_codes, against the plain version
    over the same shards."""
    mesh = Mesh([device] * 3)
    n = (1 << 25) // 10     # m rounds up to 2^25, padded to a multiple of 3
    bf = ShardedCBF(n, 0.01, 0, mesh=mesh)
    plain = [torch.zeros(bf.m_local, dtype=torch.uint8, device=device)
             for _ in range(3)]
    codes = torch.from_numpy(
        encode_bases_np(next(iter(fixture_genome.values())))).to(device)
    bf.add_codes(codes, K)
    for p, lo in zip(plain, bf.los):
        cbf_add_codes_plain(p, codes, K, bf.seeds_t[0], bf.size, lo)
    keys, _ = _genome_batch(genome_row_codes(
        codes, K, 0, min(BATCH, genome_rows(codes.numel(), K))))
    got = torch.from_numpy(bf.count(keys))
    want = torch.stack([cbf_count_plain(p, keys, bf.seeds_t[0], bf.size, lo)
                        for p, lo in zip(plain, bf.los)]).amin(dim=0).cpu()
    err = max(max(_max_abs_diff_u8(s, p) for s, p in zip(bf.shards, plain)),
              _max_abs_diff_u8(got, want))
    print(f"  3 shards: m={bf.size} (not a power of two), {bf.m_local} cells "
          f"a shard, kh={bf.num_hashes}, the fixture chromosome through "
          f"add_codes; kernel vs plain "
          f"max_abs_err {err}; {int(sum(s.count_nonzero() for s in bf.shards))} "
          f"nonzero")
    if err:
        fail("the 3-shard filter kernels disagree with plain")
    return err


def time_shard(device) -> tuple[dict[str, tuple], int]:
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
        bms, by = cbf_bound(op, keys, mask, seeds, m, lo, SHARD_CELLS)
        out[op] = (min(k1, k2), min(p1, p2), bms)
        print(f"  shard {op}, {keys.numel()} keys x kh {CBF_TIMING_KH}: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
    return out, err


def phase_mesh(device, work: str, cfg_path: str, counts: str, vcf4: str,
               ref: str, big_filter, fixture_genome):
    """The mesh phase; returns (launches of its main paths, the filter
    kernels' max abs error, the per-shard times)."""
    mesh = _mesh(device)
    launches = collections.Counter()
    err, _, filter_launches = check_sharded_big_filter(mesh, ref, big_filter)
    launches.update(filter_launches)
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
        if (LAUNCHES["cbf_add_codes"] < mesh.size or LAUNCHES["cbf_add"]
                or LAUNCHES["cbf_count"] < mesh.size
                or not LAUNCHES["sketch_contexts"]):
            fail("the sharded construct did not launch the filter kernels "
                 "on every shard and the context sketch")
        if compare_vgt(port_vgt, os.path.join(FIXTURE, "graph.vgt")):
            fail("the sharded construct differs from the committed graph")

        # genotype over the mesh: replicated counting, window-sharded fb
        LAUNCHES.clear()
        counters = timing.counters()
        mesh_counts = os.path.join(work, "counts_mesh.npz")
        with counted_plain() as calls:
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
    check_counted_per_batch(log_text, LAUNCHES, "genotype over the mesh")
    check_scoring_on_card(LAUNCHES, calls, "genotype over the mesh")
    check_posterior_on_card(LAUNCHES, timing.counters_since(counters),
                            "genotype over the mesh")
    check_prep_on_card(LAUNCHES, timing.counters_since(counters),
                       "genotype over the mesh")
    if LAUNCHES["forward_backward"] < mesh.size:
        fail("genotype over the mesh did not launch forward_backward on "
             "every device")
    print(f"  genotype over the mesh: count_packed launches "
          f"{LAUNCHES['count_packed']}; counting and fb spread over it: "
          f"{spread}; coverage equal to phase 4's: {same_cov}; VCF "
          f"byte-identical to phase 4's: {same_vcf}")
    if not (spread and same_cov and same_vcf):
        fail("genotype over the mesh differs from one device")
    shard_times, e = time_shard(device)
    return launches, max(err, e), shard_times


# ---------------------------------------------------------------- phase 13

def fb_states(P: int, S: int, rng) -> list[list[int]]:
    """S states of ploidy P: at P = 2 the diploid het combinations of the
    fewest haplotypes that give S, in increment_vector's order; above, random
    multisets of P + 2 haplotypes (every overlap class 0..P occurs)."""
    if P == 2:
        h = 1
        while h * (h + 1) // 2 < S:
            h += 1
        return increment_vector(list(range(h)), "het", 2, h - 1)[:S]
    return [sorted(rng.integers(0, P + 2, P).tolist()) for _ in range(S)]


def fb_pair_overlap(states: list[list[int]], device) -> np.ndarray:
    """[S, S] int32 overlap of diploid states, formed on the card: the larger
    matching of two pairs, max([a = c] + [b = d], [a = d] + [b = c]), which is
    state_overlap's multiset intersection for P = 2 without its
    [S, S, haplotypes] intermediate."""
    st = torch.tensor(states, dtype=torch.int32, device=device)
    a, b = st[:, 0], st[:, 1]
    same = (a[:, None] == a[None, :]).int() + (b[:, None] == b[None, :]).int()
    cross = (a[:, None] == b[None, :]).int() + (b[:, None] == a[None, :]).int()
    return torch.maximum(same, cross).to(torch.int32).cpu().numpy()


def fb_inputs(device, W: int, N: int, S: int, P: int, seed: int,
              edges: bool, variant: str | None = None) -> list[torch.Tensor]:
    """(logE, kind, lrf, lnrf, lrb, lnrb, overlap, log_w, smask) on the
    card: W windows of N real nodes and S states.  With ``edges``: window 0
    resets at its first and last node and has zero distances in both
    directions at every 7th node, window 1 holds pad nodes only, window 2
    half its states valid (the rest padded, as a group pads a smaller
    window) and pad nodes at its end.  ``variant`` (FB_EDGE_VARIANTS)
    rewrites the overlap or the distances."""
    rng = np.random.default_rng(seed)
    states = fb_states(P, S, rng)
    one = (fb_pair_overlap(states, device) if P == 2
           else engine_torch_mod.state_overlap(states))
    ov = np.broadcast_to(one, (W, S, S)).copy()
    del one
    if variant == "dense":          # a random class 0..P in every entry
        ov = rng.integers(0, P + 1, (W, S, S)).astype(np.int32)
    elif variant == "all_zero":
        ov[:] = 0
    elif variant == "all_P":
        ov[:] = P
    elif variant == "above_P":      # classes above P weigh 0
        ov[0, 1, 2] = P + 3
        ov[3, :, 5] = P + 1
        ov[3, 7, :] = 255
    smask = np.ones((W, S), bool)
    kind = np.ones((W, N), np.int32)
    dist = rng.integers(0, 200_000, (W, 2, N))
    if edges:
        kind[0, [0, N - 1]] = 2
        dist[0, :, ::7] = 0
        kind[1] = 0
        smask[2, S // 2 + 1:] = False
        ov[2][~smask[2]] = 0
        ov[2][:, ~smask[2]] = 0
        kind[2, N - N // 4:] = 0
    if variant == "far":            # exp(-d / n) is 0: rec = norec
        dist[:] = 10 ** 14
    gen = torch.Generator(device=device).manual_seed(seed)
    logE = torch.randn((W, N, S), generator=gen, device=device) * 6.0 - 40.0
    sm = torch.from_numpy(smask).to(device)
    logE = torch.where(sm[:, None, :], logE, -math.inf).contiguous()
    w = rng.random((W, S))
    log_w = np.where(smask, np.log(w / w.sum(axis=1, keepdims=True)), 0.0)
    lrf, lnrf = engine_torch_mod._transition_logs(dist[:, 0], 2 * BIG_SAMPLES + 1)
    lrb, lnrb = engine_torch_mod._transition_logs(dist[:, 1], 2 * BIG_SAMPLES + 1)
    if variant == "far" and not (np.array_equal(lrf, lnrf)
                                 and np.array_equal(lrb, lnrb)):
        fail("the far distances did not give rec = norec")
    host = [kind, lrf, lnrf, lrb, lnrb, ov, log_w.astype(np.float32)]
    return [logE, *(torch.from_numpy(a).to(device) for a in host), sm]


def fb_flow_steps(kind: np.ndarray) -> np.ndarray:
    """Each window's steps of both directions that compute a flow: real
    nodes that are not the first real node of their chain (a chain starts at
    the window's end it is walked from and after each reset)."""
    steps = np.zeros(kind.shape[0], np.int64)
    for k in (kind, kind[:, ::-1]):
        for w in range(k.shape[0]):
            real = k[w] == 1
            steps[w] += int(real.sum()) - len(np.unique(np.cumsum(k[w] == 2)[real]))
    return steps


def fb_bound(W: int, N: int, S: int, steps: np.ndarray, nonzero: np.ndarray
             ) -> tuple[tuple[float, str], tuple[float, str]]:
    """((ms, what sets it) counting this run's work, the same with the
    dense flow): logE read once a direction and alpha and beta written
    (4 x W*N*S float32) through HBM, against the rec flow's float32
    operations at the data sheet's rate, whichever is longer.  The flow
    sums a window's overlap entries that are not class 0 (``nonzero``, a
    window), 2 operations each a flow step (class 0 enters through the
    row's sum); the dense count is 2 S^2 a flow step, PR 6's bound."""
    tb = 4 * W * N * S * 4 / HBM_BYTES_PER_S * 1e3
    out = []
    for per_step in (2 * nonzero.astype(np.float64), np.full(W, 2.0 * S * S)):
        to = float((steps * per_step).sum()) / FP32_FLOPS_PER_S * 1e3
        out.append((tb, "bytes") if tb >= to else (to, "operations"))
    return out[0], out[1]


def modeled_wavefronts(lists: torch.Tensor, goff: torch.Tensor, S: int
                       ) -> tuple[float, float]:
    """(shared-memory wavefronts of one warp's gather request as a model
    predicts them, list slots a column over nonzero entries a column), from
    the layout the kernel reads, not from a profiler: in a warp, lane j
    reads row[s] for s = slot k of column j, and the model takes a request
    to cost as many wavefronts as its busiest bank (32 banks of 4 bytes) has
    distinct addresses.  Each window's own slots count; the pad index S is
    one address."""
    W = lists.shape[0]
    slots = lists.permute(0, 1, 3, 2).reshape(W, -1, S).long()   # [W, L, S]
    L = slots.shape[1]
    nwarps = (S + 31) // 32
    a = torch.nn.functional.pad(slots, (0, nwarps * 32 - S), value=-1)
    a = a.view(W, L, nwarps, 32)
    own = (torch.arange(L, device=a.device)[None, :]
           < goff[:, -1:].long())                               # [W, L]
    req = torch.arange(W * L * nwarps, device=a.device).view(W, L, nwarps, 1)
    m = own[:, :, None, None] & (a >= 0)
    pairs = torch.unique(req.expand_as(a)[m] * (S + 1) + a[m])
    r, addr = pairs // (S + 1), pairs % (S + 1)
    busiest = torch.bincount(r * 32 + addr % 32, minlength=W * L * nwarps * 32)
    busiest = busiest.view(-1, 32).amax(dim=1)
    n_req = int(own.sum()) * nwarps
    real = int(((slots < S) & own[:, :, None]).sum())
    return float(busiest.sum()) / max(n_req, 1), int(own.sum()) * S / max(real, 1)


def _fb_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def fb_group(device, S: int, plain_w: int, split_row: int | None = None) -> dict:
    """The genome-scale group (FB_GROUP_W windows of FB_GROUP_N nodes at S
    states, P = 2) timed through the wrapper in rec and fre mode, its layout
    alone, the bounds and the gather's modeled conflicts; the kernel held against
    plain on the first ``plain_w`` windows (a window's rows do not depend on
    the rest of the batch), and plain timed there once; with ``split_row``,
    that window alone must equal its row of the batch bit for bit."""
    plain = engine_torch_mod._forward_backward_plain
    W, N = FB_GROUP_W, FB_GROUP_N
    t = fb_inputs(device, W, N, S, 2, 99, edges=False)
    ov = t[6]
    nonzero = ((ov >= 1) & (ov <= 2)).sum(dim=(1, 2)).cpu().numpy()

    def kernel():
        return fb_cuda.forward_backward(*t, False, 2)

    first = kernel()
    kms = time_ms(kernel)
    # the same group in fre mode, whose flow is O(S) a step: the step's
    # skeleton (barrier, reduction, exp, loads and stores) without the flow
    fre_ms = time_ms(lambda: fb_cuda.forward_backward(*t, True, 2))
    layout_ms = time_ms(lambda: fb_cuda.fb_layout(ov, 2))
    lists, goff, _ = fb_cuda.fb_layout(ov, 2)
    wavefronts, slot_ratio = modeled_wavefronts(lists, goff, S)
    words = lists.shape[1]
    del lists, goff
    again = kernel()
    torch.cuda.synchronize()
    same_runs = all(torch.equal(x, y) for x, y in zip(first, again))
    del again
    sub = [x[:plain_w].contiguous() for x in t]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = plain(*sub, False, 2)
    end.record()
    torch.cuda.synchronize()
    pms = start.elapsed_time(end)
    err = _fb_diff([f[:plain_w] for f in first], want)
    del want
    same_row = True
    if split_row is not None:
        one = fb_cuda.forward_backward(
            *(x[split_row:split_row + 1].contiguous() for x in t), False, 2)
        torch.cuda.synchronize()
        same_row = all(torch.equal(o[0], f[split_row]) for o, f in zip(one, first))
        print(f"  window {split_row} alone bit-identical to row {split_row} of "
              f"the batch: {same_row}")
        del one
    steps = fb_flow_steps(t[1].cpu().numpy())
    (bms, by), (dms, dby) = fb_bound(W, N, S, steps, nonzero)
    share = float(nonzero.sum()) / (W * S * S)
    print(f"  fb at W={W} N={N} S={S} P=2 rec ({int(steps.sum())} flow steps, "
          f"{share:.4f} of the overlap not class 0): kernel {kms:.4f} ms "
          f"(median of {TIMING_RUNS}; the layout alone {layout_ms:.4f} ms), "
          f"plain on {plain_w} windows {pms:.1f} ms (once), bound {bms:.4f} ms "
          f"({by}; dense count {dms:.4f} ms, {dby}); the same group in fre "
          f"mode {fre_ms:.4f} ms; {words} list words a column, "
          f"{wavefronts:.3f} wavefronts a gather request (a model), {slot_ratio:.3f} "
          f"slots a nonzero entry; kernel vs plain max_abs_err {err:.3g}; "
          f"two runs bit-identical: {same_runs}")
    if not (err <= FB_ATOL and same_runs and same_row):
        fail(f"forward_backward at the S = {S} group disagrees with plain or "
             "is not deterministic")
    return {"ms": kms, "plain_ms": pms, "plain_windows": plain_w,
            "bound_ms": bms, "bound_by": by, "dense_bound_ms": dms,
            "dense_bound_by": dby, "fre_ms": fre_ms, "layout_ms": layout_ms,
            "nonzero_share": share, "modeled_wavefronts": wavefronts,
            "slot_ratio": slot_ratio, "err": err}


def phase_fb(device) -> tuple[dict, dict, float]:
    """Phase 13: the kernel against plain on the edge cases, then the
    groups at S = 120 (with the split invariance) and at S = 465; returns
    (the S = 120 group's numbers, the S = 465 group's, the max abs
    difference from plain)."""
    plain = engine_torch_mod._forward_backward_plain
    worst = 0.0
    max_states = int(fb_cuda.build().vg_fb_max_states())
    # (P, S, N, variant, W): with W = FB_EDGE_W the edges of fb_inputs
    shapes = ([(P, S, FB_EDGE_N, None, FB_EDGE_W) for P, S in FB_EDGE_SHAPES]
              + [(2, 15, 1, None, FB_EDGE_W)]
              + [(2, 120, FB_EDGE_N, v, FB_EDGE_W) for v in FB_EDGE_VARIANTS]
              + [(2, 780, FB_EDGE_N, "dense", FB_EDGE_W),
                 (2, max_states, FB_MAX_N, None, 1)])
    for seed, (P, S, N, variant, W) in enumerate(shapes):
        t = fb_inputs(device, W, N, S, P, seed, edges=N > 1 and W >= 3,
                      variant=variant)
        for fre in (False, True):
            got = fb_cuda.forward_backward(*t, fre, P)
            want = plain(*t, fre, P)
            again = fb_cuda.forward_backward(*t, fre, P)
            torch.cuda.synchronize()
            err = _fb_diff(got, want)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            tag = f"P={P} S={S} N={N} W={W}" + (f" {variant}" if variant else "")
            print(f"  fb {tag} {'fre' if fre else 'rec'}: kernel vs plain "
                  f"max_abs_err {err:.3g}, two runs bit-identical: {same}")
            if not (err <= FB_ATOL and same):
                fail(f"forward_backward disagrees with plain at {tag} fre={fre}")
            worst = max(worst, err)
            del got, want, again
        del t
        torch.cuda.empty_cache()
    print(f"  fb: the most states a launch takes is {max_states}")

    # a window alone (lists in registers) against the same window beside a
    # window of dense overlap (more than 32 words a column: the list path)
    for S in (FB_GROUP_S, FB_BIG_S):
        t = fb_inputs(device, FB_MIXED_W, FB_MIXED_N, S, 2, 50 + S, edges=False)
        t[6][1] = torch.randint(0, 3, (S, S), device=device, dtype=torch.int32)
        one = fb_cuda.forward_backward(*(x[:1].contiguous() for x in t), False, 2)
        got = fb_cuda.forward_backward(*t, False, 2)
        want = plain(*t, False, 2)
        torch.cuda.synchronize()
        err = _fb_diff(got, want)
        same = all(torch.equal(o[0], g[0]) for o, g in zip(one, got))
        print(f"  fb S={S}: window 0 alone bit-identical to row 0 of a batch "
              f"beside a dense window: {same}; the batch vs plain max_abs_err "
              f"{err:.3g}")
        if not (err <= FB_ATOL and same):
            fail(f"forward_backward at S = {S} changes beside a dense window")
        worst = max(worst, err)
        del t, one, got, want

    g120 = fb_group(device, FB_GROUP_S, FB_GROUP_W, split_row=FB_ROW)
    torch.cuda.empty_cache()
    g465 = fb_group(device, FB_BIG_S, FB_BIG_PLAIN_W)
    torch.cuda.empty_cache()
    return g120, g465, max(worst, g120["err"], g465["err"])


# ---------------------------------------------------------------- phase 14

def phase_big_genotype(device, work: str, big_vgt: str, haps, truth):
    """Genotype S1 on the 100 Mb graph through the CLI, then in-process on
    the saved counts the kernels against the plain forward/backward and
    against the plain emissions; returns (the CLI run's launches, the
    in-process group's emission arguments)."""
    fqs = [os.path.join(work, f"big_S1_{i}.fq.gz") for i in range(BIG_READ_FILES)]
    t0 = time.perf_counter()
    n_reads = gen_big.write_reads(fqs, haps, BIG_DEPTH,
                                  np.random.default_rng(BIG_SEED + 1))
    print(f"  wrote {n_reads} reads of {gen_big.READ_LEN} bp ({BIG_DEPTH:g}x "
          f"total) into {len(fqs)} FASTQ files in {time.perf_counter() - t0:.1f} s")
    cfg_path = os.path.join(work, "big_samples.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("S1 " + " ".join(fqs) + "\n")
    counts = os.path.join(work, "big_counts.npz")
    LAUNCHES.clear()
    counters = timing.counters()
    with counted_plain() as calls:
        t0 = time.perf_counter()
        vcf, log_text = run_main_path("cuda", work, cfg_path, counts,
                                      graph=big_vgt, out_name="out_big")
        wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check_counted_per_batch(log_text, launches, f"the {BIG_MB} Mb genotype")
    check_scoring_on_card(launches, calls, f"the {BIG_MB} Mb genotype")
    check_posterior_on_card(launches, timing.counters_since(counters),
                            f"the {BIG_MB} Mb genotype")
    check_prep_on_card(launches, timing.counters_since(counters),
                       f"the {BIG_MB} Mb genotype")
    print(f"  launches {launches}")
    print("  phase timings:")
    print_timings(phase_timings(log_text), wall)
    agree, sites = gt_agreement(vcf, truth)
    print(f"  S1 GT agrees with the generator's truth at {agree}/{sites} sites "
          f"({agree / sites:.4f}; reported, not a gate)")

    gi = load_graph(big_vgt, device=device)
    graph2node(gi)
    read_base = load_counts(gi, counts)
    cfg = VarigraphConfig(device="cuda")
    hap_cov = estimate_hap_coverage(
        gi.table.cov_u8(), gi.table.freq_np(), gi.table.hap_words_np(),
        gi.nhap, gi.vcf_ploidy, cfg.sample_ploidy, read_base / gi.genome_size,
        cfg.use_depth)
    shapes, groups, post_groups = [], [], []
    saved = (engine_torch_mod._forward_backward, engine_torch_mod.emissions_,
             engine_torch_mod.posterior_)

    def recorded_fb(logE, *a):
        shapes.append(tuple(logE.shape))
        return fb_cuda.forward_backward(logE, *a)

    def recorded_emit(out, *a):
        groups.append(a)
        emit_cuda.emissions_(out, *a)

    def recorded_post(out, *a):
        post_groups.append(tuple(t.clone() for t in a))
        post_cuda.posterior_(out, *a)

    def run():
        t0 = time.perf_counter()
        res = genotype_torch(gi, cfg, hap_cov, cfg.seed, device=device)
        return res, time.perf_counter() - t0

    try:
        engine_torch_mod._forward_backward = recorded_fb
        engine_torch_mod.emissions_ = recorded_emit
        engine_torch_mod.posterior_ = recorded_post
        res_k, t_k = run()
        engine_torch_mod.posterior_ = saved[2]
        engine_torch_mod.emissions_ = saved[1]
        engine_torch_mod._forward_backward = engine_torch_mod._forward_backward_plain
        res_p, t_p = run()
        engine_torch_mod._forward_backward = saved[0]
        engine_torch_mod.emissions_ = plain_emissions_chunked
        res_e, t_e = run()
        engine_torch_mod.emissions_ = saved[1]
        engine_torch_mod.posterior_ = plain_posterior_on_host
        res_q, t_q = run()
    finally:
        (engine_torch_mod._forward_backward, engine_torch_mod.emissions_,
         engine_torch_mod.posterior_) = saved
    node_at = {(c, n.start): n for c in gi.graph.nodes for n in gi.graph.nodes[c]}

    def gt(rec, key):
        return sorted(int(node_at[key].hap_gt[h]) for h in rec.hap_vec)

    def differ(other, what):
        if set(res_k) != set(other) or not res_k:
            fail(f"the kernels and the plain {what} scored different sites")
        mism = sum(gt(res_k[k], k) != gt(other[k], k) or res_k[k].uk != other[k].uk
                   or res_k[k].kmer_num_vec != other[k].kmer_num_vec
                   for k in res_k)
        gpp = max(abs(res_k[k].probability - other[k].probability) for k in res_k)
        return mism, gpp

    (mism, gpp), (mism_e, gpp_e), (mism_q, gpp_q) = (
        differ(res_p, "forward/backward"), differ(res_e, "emissions"),
        differ(res_q, "posterior"))
    print(f"  genotype_torch on the saved counts, {len(res_k)} sites over "
          f"groups (W, N, S) {shapes}: the kernels {t_k:.2f} s, the plain "
          f"forward/backward routed in {t_p:.2f} s, the plain emissions routed "
          f"in {t_e:.2f} s, the plain posterior routed in {t_q:.2f} s (host "
          f"clock); against the plain forward/backward "
          f"{mism} GT/UK/NAK mismatches, max |GPP diff| {gpp:.3g}; against "
          f"the plain emissions {mism_e}, {gpp_e:.3g}; against the plain "
          f"posterior {mism_q}, {gpp_q:.3g}")
    if not shapes or any(s[2] != 120 for s in shapes):
        fail(f"the {BIG_MB} Mb genotype did not score at S = 120")
    if mism or gpp > GPP_TOL:
        fail("the kernel's calls differ from the plain forward/backward's")
    if mism_e or gpp_e > GPP_TOL:
        fail("the emissions kernel's calls differ from the plain emissions'")
    if mism_q or gpp_q:
        fail("the posterior kernel's records differ from the plain posterior's")
    return launches, groups[0], post_groups[0]


def plain_posterior_on_host(out, *a):
    """The plain posterior on host copies of a card call's inputs, its
    results copied back."""
    o = out.cpu()
    posterior_plain(o, *(t.cpu() for t in a))
    out.copy_(o)


# ---------------------------------------------------------------- phase 15

LONG_CONTEXTS, LONG_CONTEXT_K = (50_000, 1_000_000), 28


def genome_keys(genome: dict[str, torch.Tensor], k: int, device) -> torch.Tensor:
    """Every value the genome's rows emit (the plain sketch) and decoys,
    half of them with bit 63 set, sorted and unique as unsigned values."""
    vals = []
    for codes in genome.values():
        values, emit = sketch_codes(
            genome_row_codes(codes, k, 0, genome_rows(codes.numel(), k)), k)
        vals.append(values[emit])
    decoys = _kmer_values(500, torch.Generator(device=device).manual_seed(k),
                          device, span=k)
    decoys[::2] |= -(1 << 63)
    return _sorted_unique(torch.cat([*vals, decoys]))


def check_count_codes(device) -> int:
    """count_codes_ against plain on the edge genomes at k = 5, 16, 27, 28,
    at each table's own directory and at skewed ones; returns the max abs
    difference (must be 0)."""
    worst = 0
    for k in PACKED_CASE_KS:
        genome = {c: torch.from_numpy(v).to(device)
                  for c, v in edge_genome(k).items()}
        keys = genome_keys(genome, k, device)
        want = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        for codes in genome.values():
            count_codes_plain(want, keys, codes, k)
        bm = sketch_cuda.key_bitmap(keys, bitmap_bits(keys.numel()))
        if not torch.equal(bm, key_bitmap_plain(keys, bitmap_bits(keys.numel()))):
            fail(f"the key bitmap kernel disagrees with plain at k={k}")
        for bits in (directory_bits(keys.numel()), *SKEWED_DIRECTORY_BITS):
            got = torch.zeros_like(want)
            for codes in genome.values():
                sketch_cuda.count_codes_(got, keys, key_directory(keys, bits),
                                         bm, codes, k)
            torch.cuda.synchronize(device)
            err = int((got - want).abs().max())
            print(f"  count_codes k={k}: {keys.numel()} keys "
                  f"({int((keys < 0).sum())} with bit 63), directory 2^{bits}, "
                  f"max count {int(want.max())}, max_abs_err {err}")
            if err:
                fail(f"count_codes disagrees with plain at k={k}, directory 2^{bits}")
            worst = max(worst, err)
        if int(want.max()) <= 255:
            fail(f"the poly-A run did not count past 255 at k={k}")
    return worst


def context_cases(k: int) -> list[str]:
    """Contexts of lengths 0, 1, k - 1, k, k + 1, 160, 3,000 and random ones
    with a few Ns; one with N runs (one longer than k) and single Ns, one of
    (AT)n around random bases, one poly-A, one in lower case."""
    rng = np.random.default_rng(100 + k)

    def rand(n, p_n=0.0):
        p = [(1 - p_n) / 4] * 4 + [p_n]
        return "".join(rng.choice(list("ACGTN"), size=int(n), p=p))

    ctxs = [rand(n) for n in (0, 1, k - 1, k, k + 1, GENOME_COLS, 3000)]
    ctxs += [rand(n, 0.02) for n in rng.integers(k, 300, 20)]
    ctxs.append(rand(150) + "N" * (2 * k + 1) + rand(90) + "N" + rand(40))
    ctxs.append("AT" * 60 + rand(50) + "TA" * 40)
    ctxs.append("A" * 400)
    ctxs.append(rand(200, 0.02).lower())
    return ctxs


def _to_card(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


def check_contexts(device) -> int:
    """The context kernel against plain on the edge cases at k = 5, 16, 27,
    28, and against sketch_ref on contexts at the short route's tile, one
    window past it, and of 50,000 and 1,000,000 bases (the last three take
    the long route); returns 0 (any difference fails)."""
    for k in PACKED_CASE_KS:
        codes, offsets = _to_card(encode_contexts(context_cases(k)), device)
        got = sketch_cuda.sketch_contexts(codes, offsets, k)
        want = sketch_contexts_plain(codes, offsets, k)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"  sketch_contexts k={k}: {offsets.numel() - 1} contexts, "
              f"{got[0].numel()} values, equal to plain: {same}")
        if not same:
            fail(f"the context kernel disagrees with plain at k={k}")
    rng = np.random.default_rng(5)
    tile = sketch_cuda.CONTEXT_TILE + LONG_CONTEXT_K - 1   # bases of a full tile
    ctxs = []
    for n in (tile, tile + 1, *LONG_CONTEXTS):
        c = rng.integers(0, 4, n).astype(np.uint8)
        if n > 10_000:
            c[n // 3:n // 3 + 5000] = 4
            c[n // 2:n // 2 + 2000] = np.tile([0, 3], 1000)
            c[n // 4:n // 4 + 3000] = 0
        c[rng.integers(0, n, 50)] = 4
        ctxs += [np.frombuffer(b"ACGTN", np.uint8)[c].tobytes().decode(), "ACGT" * 10]
    codes, offsets = _to_card(encode_contexts(ctxs), device)
    sketch_cuda.LONG_ROUTE.clear()
    values, starts = sketch_cuda.sketch_contexts(codes, offsets, LONG_CONTEXT_K)
    v, st = values.cpu().numpy().view(np.uint64), starts.cpu().numpy()
    for i, c in enumerate(ctxs):
        want = np.unique(np.array(sketch_ref(c, LONG_CONTEXT_K), np.uint64))
        same = np.array_equal(v[st[i]:st[i + 1]], want)
        print(f"  sketch_contexts k={LONG_CONTEXT_K}, a context of {len(c)} bases "
              f"(beside {len(ctxs) - 1} others): {len(want)} unique values, "
              f"equal to sketch_ref: {same}")
        if not same:
            fail(f"the context kernel disagrees with sketch_ref on {len(c)} bases")
    n_long = sketch_cuda.LONG_ROUTE["contexts"]
    print(f"  contexts on the long route: {n_long} (those of more than {tile} bases)")
    if n_long != 3:
        fail(f"{n_long} contexts took the long route, not the 3 longest")
    return 0


def old_exact_path(cov, keys, directory, bitmap, codes, k):
    """The exact count before count_codes: rows of a batch through the torch
    sketch, then the join kernel on its value array."""
    rows = genome_rows(codes.numel(), k)
    for r0 in range(0, rows, BATCH):
        values, emit = sketch_codes(
            genome_row_codes(codes, k, r0, min(rows, r0 + BATCH)), k)
        join_cuda.count_join_(cov, keys, directory,
                              values[:, k - 1:].reshape(-1).contiguous(),
                              emit[:, k - 1:].reshape(-1).contiguous())


def emitted_values(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """(every value the genome rows of codes emit, the bases the rows
    hold), with the plain sketch a batch of rows at a time."""
    rows = genome_rows(codes.numel(), k)
    vals = []
    for r0 in range(0, rows, BATCH):
        values, emit = sketch_codes(
            genome_row_codes(codes, k, r0, min(rows, r0 + BATCH)), k)
        vals.append(values[emit])
    # every row but the last is whole
    bases = (rows - 1) * GENOME_COLS + codes.numel() - (rows - 1) * (GENOME_COLS - k + 1)
    return torch.cat(vals), bases


def count_codes_bound(keys, directory, bitmap, values, n_codes: int,
                      bases: int) -> tuple[float, str, int]:
    """(ms, what sets it, windows whose bit is set): count_codes reads each
    code once, rolls its registers over every base of the rows and hashes
    every emitted window.  A window whose bit in the keys' bitmap is clear
    is settled by the bitmap's test and its word's sector; only a window
    whose bit is set needs the directory search (lookup_bytes)."""
    bbits = bitmap.numel().bit_length() + 4
    bshift = directory_shift(int(keys[-1]) & ((1 << 64) - 1), bbits)
    q = (values >> bshift) & ((1 << (64 - bshift)) - 1) if bshift else values
    inside = (q >= 0) & (q < 1 << bbits)
    qi = torch.where(inside, q, 0)
    passed = inside & (((bitmap[qi >> 5] >> (qi & 31)) & 1) == 1)
    n, n_set = values.numel(), int(passed.sum())
    nbytes = (n_codes + SECTOR * _sectors((qi[inside & ~passed] >> 5) * 4)
              + lookup_bytes(keys, directory, values[passed]))
    ms, by = bound(nbytes, ROLL_OPS * bases + WINDOW_OPS * n
                   + BITMAP_OPS * (n - n_set) + LOOKUP_OPS * n_set)
    return ms, by, n_set


def time_count_codes(device, tables: dict[str, torch.Tensor],
                     genome: tuple[torch.Tensor, torch.Tensor]) -> tuple[dict, int]:
    """count_codes_ on phase 7's 50 Mb chromosome (torch seed 3) against
    each table, and on ``genome`` (a chromosome's codes, the candidates
    its construct counted), held against plain, then timed (median of 7)
    beside the old path and the plain version (once each after a warm-up):
    plain, old, kernel, kernel, old, plain; with the bound from the
    chromosome's emitted windows and the table's bitmap (count_codes_bound),
    which is built once a table, outside the timing.  Returns (numbers by
    case, max abs difference)."""
    gen = torch.Generator(device=device).manual_seed(3)
    chrom = torch.randint(0, 4, (CHROM_BASES,), generator=gen, device=device,
                          dtype=torch.uint8)
    cases = [(label, chrom, keys) for label, keys in tables.items()]
    cases.append((f"{BIG_MB} Mb genome's chr1 vs its candidates", genome[0],
                  genome[1]))
    out, worst = {}, 0
    for label, chrom, keys in cases:
        values, bases = emitted_values(chrom, K)
        d = key_directory(keys, directory_bits(keys.numel()))
        bm = sketch_cuda.key_bitmap(keys, bitmap_bits(keys.numel()))
        a = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
        b = torch.zeros_like(a)
        sketch_cuda.count_codes_(a, keys, d, bm, chrom, K)
        count_codes_plain(b, keys, chrom, K)
        err = int((a - b).abs().max())
        worst = max(worst, err)
        if err:
            fail(f"count_codes disagrees with plain on the 50 Mb chromosome, {label}")

        def timed(fn, runs):
            cov = torch.zeros(keys.numel(), dtype=torch.int32, device=device)
            return time_ms(lambda: fn(cov, keys, d, bm, chrom, K), before=cov.zero_,
                           runs=runs)

        p1, o1, k1 = (timed(plain_count_codes, 1), timed(old_exact_path, 1),
                      timed(sketch_cuda.count_codes_, TIMING_RUNS))
        k2, o2, p2 = (timed(sketch_cuda.count_codes_, TIMING_RUNS),
                      timed(old_exact_path, 1), timed(plain_count_codes, 1))
        bms, by, n_set = count_codes_bound(keys, d, bm, values, chrom.numel(), bases)
        out[label] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bms,
                      "bound_by": by, "old_path_ms": min(o1, o2),
                      "keys_hit": int(a.count_nonzero()), "windows_hit": int(a.sum()),
                      "bitmap_passed": n_set}
        print(f"  count_codes, {chrom.numel()} bases ({values.numel()} windows) "
              f"against the {label} ({keys.numel()} keys, directory "
              f"2^{d.numel().bit_length() - 1}; {n_set} windows past the bitmap, "
              f"{int(a.count_nonzero())} keys "
              f"hit by {int(a.sum())} windows): kernel {k1:.4f}/{k2:.4f} ms, "
              f"old path (torch sketch + "
              f"join kernel) {o1:.2f}/{o2:.2f} ms, plain {p1:.2f}/{p2:.2f} ms, "
              f"bound {bms:.4f} ms ({by}); kernel vs plain max_abs_err {err}")
    return out, worst


def time_bitmap(device, tables: dict[str, torch.Tensor]) -> tuple[dict, int]:
    """The exact count's key bitmap (built once a table) on
    each table, held against plain, then timed (median of 7, plain once):
    plain, kernel, kernel, plain; bound by the keys read and the words
    written.  Returns (numbers by table, max abs difference)."""
    out, worst = {}, 0
    for label, keys in tables.items():
        bb = bitmap_bits(keys.numel())
        got, want = sketch_cuda.key_bitmap(keys, bb), key_bitmap_plain(keys, bb)
        err = int((got != want).sum())
        worst = max(worst, err)
        if err:
            fail(f"the key bitmap kernel disagrees with plain on the {label}")
        p1, k1 = (time_ms(lambda: key_bitmap_plain(keys, bb), runs=1),
                  time_ms(lambda: sketch_cuda.key_bitmap(keys, bb)))
        k2, p2 = (time_ms(lambda: sketch_cuda.key_bitmap(keys, bb)),
                  time_ms(lambda: key_bitmap_plain(keys, bb), runs=1))
        bms, by = bound(8 * keys.numel() + 4 * got.numel(), 4 * keys.numel())
        bits_set = (got[:, None] >> torch.arange(32, device=device)) & 1
        share = float(bits_set.count_nonzero()) / bits_set.numel()
        out[label] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bms,
                      "bound_by": by, "bits": bb, "set_share": share}
        print(f"  key_bitmap of the {label} ({keys.numel()} keys, 2^{bb} bits, "
              f"{share:.4f} set): kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.2f}/{p2:.2f} ms, bound {bms:.4f} ms ({by}); words differing "
              f"from plain {err}")
    return out, worst


def time_contexts(device, contexts: list[str]) -> dict:
    """The context sketch on phase 9's distinct contexts, held against plain,
    then timed (median of 7) beside the plain version (the old padded torch
    batches and per-context np.unique; once after a warm-up): plain,
    kernel, kernel, plain; with the contexts that took the long route and
    its bound (the codes and offsets in, the unique values and starts out,
    and the registers' and the hash's operations; the emitted windows
    counted by the long route's count pass over every context)."""
    t0 = time.perf_counter()
    host = encode_contexts(contexts)
    encode_s = time.perf_counter() - t0
    codes, offsets = _to_card(host, device)
    sketch_cuda.LONG_ROUTE.clear()
    got = sketch_cuda.sketch_contexts(codes, offsets, K)
    n_long = sketch_cuda.LONG_ROUTE["contexts"]
    want = sketch_contexts_plain(codes, offsets, K)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        fail("the context kernel disagrees with plain on phase 9's contexts")
    windows = int(sketch_cuda.context_window_counts(
        codes, offsets, torch.arange(len(contexts), device=device), K).sum())
    p1, k1 = (time_ms(lambda: sketch_contexts_plain(codes, offsets, K), runs=1),
              time_ms(lambda: sketch_cuda.sketch_contexts(codes, offsets, K)))
    k2, p2 = (time_ms(lambda: sketch_cuda.sketch_contexts(codes, offsets, K)),
              time_ms(lambda: sketch_contexts_plain(codes, offsets, K), runs=1))
    bms, by = bound(codes.numel() + 8 * (offsets.numel() + got[0].numel()
                                         + got[1].numel()),
                    ROLL_OPS * codes.numel() + WINDOW_OPS * windows)
    lens = np.diff(host[1])
    print(f"  sketch_contexts on phase 9's {len(contexts)} contexts ({codes.numel()} "
          f"bases, longest {int(lens.max()) if len(lens) else 0}; {windows} windows "
          f"emit, {got[0].numel()} unique in their contexts; {n_long} contexts on "
          f"the long route): kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.1f}/{p2:.1f} ms, bound {bms:.4f} ms ({by}); equal to plain: "
          f"{same}; host encode {encode_s:.3f} s (host clock)")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bms,
            "bound_by": by, "long_route_contexts": n_long, "encode_s": encode_s}


def phase_sketch(device, tables: dict[str, torch.Tensor], contexts: list[str],
                 genome: tuple[torch.Tensor, torch.Tensor]):
    """Phase 15; returns (count_codes' numbers by case, the context
    sketch's numbers, count_codes' max abs error, the context sketch's)."""
    err = check_count_codes(device)
    ctx_err = check_contexts(device)
    times, e = time_count_codes(device, tables, genome)
    times["bitmap"], e2 = time_bitmap(device, tables)
    e = max(e, e2)
    ctx = time_contexts(device, contexts)
    return times, ctx, max(err, e), ctx_err


# ---------------------------------------------------------------- phase 16

def plain_emissions_chunked(out, c, *rest) -> None:
    """``emissions_plain`` over the windows in chunks whose [rows, K, S]
    float32 intermediates stay within EMIT_PLAIN_BYTES each, as the engine's
    CPU path bounds them."""
    G, N, S = out.shape
    step = max(1, EMIT_PLAIN_BYTES // (N * c.shape[2] * S * 4))
    tensors, scalars = rest[:8], rest[8:]
    for g0 in range(0, G, step):
        g1 = g0 + step
        emissions_plain(out[g0:g1], c[g0:g1], *(t[g0:g1] for t in tensors),
                        *scalars)


def emit_bound(args) -> tuple[float, str]:
    """(ms, what sets it): every input read once and logE written once
    through HBM, against the state loop's operations on this run's data,
    2P + 1 a (node, valid k-mer, valid state) -- P bit tests, P - 1 adds,
    the table's index and the float add -- at the int32 rate."""
    c, kmask, state_u, smask = args[0], args[3], args[7], args[8]
    G, N, _ = c.shape
    nbytes = sum(t.numel() * t.element_size() for t in args[:9]) + G * N * smask.shape[1] * 4
    triples = float((kmask.sum(dim=2, dtype=torch.float64)
                     * smask.sum(dim=1, dtype=torch.float64)[:, None]).sum())
    return bound(nbytes, triples * (2 * state_u.shape[2] + 1))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def emit_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, bool]:
    """(max |got - want| / |want| and max |got - want| over the finite
    values, whether -inf, NaN and the finite values sit at the same
    places)."""
    same = all(torch.equal(fn(got), fn(want))
               for fn in (torch.isneginf, torch.isnan, torch.isfinite))
    fin = torch.isfinite(want) & torch.isfinite(got)
    d = (got - want).abs()[fin]
    rel = torch.where(d == 0, 0.0, d / want.abs()[fin])
    return (float(rel.max()) if d.numel() else 0.0,
            float(d.max()) if d.numel() else 0.0, same)


def emit_bare_ms(out: torch.Tensor, args) -> float:
    """The kernel alone: EMIT_BARE_LAUNCHES back-to-back ``vg_emissions``
    launches on pointers prepared once (no wrapper, no launch count), the
    median of TIMING_RUNS timings divided by their number."""
    lib = emit_cuda.build()
    tensors, scalars = args[:9], [float(x) for x in args[9:]]
    G, N, S = out.shape
    dims = (G, N, S, tensors[4].shape[2], tensors[4].shape[3], tensors[7].shape[2])
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def launches():
        for _ in range(EMIT_BARE_LAUNCHES):
            rc = lib.vg_emissions(*ptrs, *dims, *scalars, stream)
            if rc != 0:
                fail(f"vg_emissions failed: CUDA error {rc}")

    return time_ms(launches) / EMIT_BARE_LAUNCHES


def check_emit(name: str, args, split_row: int | None = None,
               timed: bool = True) -> dict:
    """The kernel against the plain version on ``args`` (the wrapper's
    arguments after out), two runs bit-identical; with ``split_row`` that
    window alone bit-identical to its row; ``timed``: the kernel and plain
    timed (median of TIMING_RUNS) beside the bound."""
    c, smask = args[0], args[8]
    shape = tuple(c.shape[:2]) + (smask.shape[1],)
    out = torch.empty(shape, dtype=torch.float32, device=c.device)

    def kernel():
        emit_cuda.emissions_(out, *args)

    kernel()
    torch.cuda.synchronize()
    first = out.clone()
    want = torch.empty_like(out)
    plain_emissions_chunked(want, *args)
    rel, err, same = emit_diff(first, want)
    kernel()
    torch.cuda.synchronize()
    same_runs = torch.equal(_bits(out), _bits(first))
    same_row = True
    if split_row is not None:
        one = torch.empty((1,) + shape[1:], dtype=torch.float32, device=c.device)
        emit_cuda.emissions_(one, *(t[split_row:split_row + 1] for t in args[:9]),
                             *args[9:])
        torch.cuda.synchronize()
        same_row = torch.equal(_bits(one[0]), _bits(first[split_row]))
    G, N, S = shape
    res = {"G": G, "N": N, "S": S, "P": int(args[7].shape[2]),
           "W": int(args[4].shape[3]), "max_rel_err": rel, "max_abs_err": err}
    line = (f"  emissions {name} (G, N, S, P, W) = ({G}, {N}, {S}, {res['P']}, "
            f"{res['W']}): kernel vs plain max rel err {rel:.3g}, max abs err "
            f"{err:.3g}, -inf/NaN at the same places: {same}; two runs "
            f"bit-identical: {same_runs}")
    if split_row is not None:
        line += f"; window {split_row} alone bit-identical to its row: {same_row}"
    if timed:
        res["ms"] = emit_bare_ms(out, args)
        res["call_ms"] = time_ms(kernel)
        res["plain_ms"] = time_ms(lambda: plain_emissions_chunked(want, *args))
        res["bound_ms"], res["bound_by"] = emit_bound(args)
        line += (f"; bare kernel {res['ms']:.4f} ms ({EMIT_BARE_LAUNCHES} launches "
                 f"a timing), the call {res['call_ms']:.4f} ms, plain "
                 f"{res['plain_ms']:.2f} ms (medians of {TIMING_RUNS}), bound "
                 f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    print(line)
    if not (same and rel <= EMIT_RTOL and same_runs and same_row):
        fail(f"the emissions kernel disagrees with plain on {name}, or is not "
             "deterministic")
    return res


def emit_group(device, states, n_used: int, seed: int):
    """The wrapper's arguments after out for EMIT_G windows of EMIT_N nodes,
    each window with the states ``states`` [S, P] over n_used used
    haplotypes: each node a prefix of 1..128 valid k-mers (as the window
    prep packs them), coverage Poisson(10), frequencies 1-4, ref flags at
    0.3, random hap, local and gt0 bits over the used haplotypes."""
    rng = np.random.default_rng(seed)
    G, N, K = EMIT_G, EMIT_N, engine_torch_mod.MAX_NODE_KMERS
    W = -(-n_used // 32)
    nk = rng.integers(1, K + 1, (G, N))
    kmask = np.arange(K)[None, None, :] < nk[..., None]
    c = rng.poisson(10.0, (G, N, K)).clip(0, 255).astype(np.uint8)
    f = rng.integers(1, 5, (G, N, K)).astype(np.uint8)
    flag = rng.random((G, N, K)) < 0.3
    bits = test_torch_emit._words(rng, (G, N, K, W), n_used)
    local = test_torch_emit._words(rng, (G, N, K, W), n_used)
    gt0 = rng.random((G, N, 32 * W)) < 0.5
    gt0[..., n_used:] = False
    state_u = np.repeat(np.asarray(states, np.int32)[None], G, axis=0)
    smask = np.ones((G, len(states)), bool)
    arrays = [c, f, flag, kmask, bits, local, gt0, state_u, smask]
    return (*test_torch_emit._torch(arrays, device),
            *test_torch_emit._scalars(10.3))


def phase_emit(device, big_group) -> dict:
    """Phase 16; returns the 100 Mb group's numbers with the S = 465, P = 4
    and W = 2 groups' under ``s465``, ``p4`` and ``w2`` and the worst error
    over every case under ``max_abs_err``/``max_rel_err``."""
    done = []
    for name in test_torch_emit.CASES + list(test_torch_emit.LARGE):
        arrays, scal = test_torch_emit.case_arrays(name)
        done.append(check_emit(f"case {name}",
                               (*test_torch_emit._torch(arrays, device), *scal),
                               timed=False))
    big = check_emit(f"the {BIG_MB} Mb group", big_group, split_row=EMIT_ROW)
    pairs = [(i, j) for i in range(40) for j in range(i + 1, 40)]
    groups = {
        "s465": ([(i, j) for i in range(31) for j in range(i + 1, 31)], 31),
        "p4": (list(itertools.combinations_with_replacement(range(8), 4)), 8),
        "w2": (pairs[::6] + [(u, u) for u in range(0, 40, 8)], 40),
    }
    for i, (key, (states, n_used)) in enumerate(groups.items()):
        big[key] = check_emit(f"synthetic {key}",
                              emit_group(device, states, n_used, 160 + i))
        done.append(big[key])
    big["max_rel_err"] = max(r["max_rel_err"] for r in done + [big])
    big["max_abs_err"] = max(r["max_abs_err"] for r in done + [big])
    return big


# ---------------------------------------------------------------- phase 17

def post_bound(args) -> tuple[float, str]:
    """The least time of the posterior's bytes: each real row's alpha and
    beta, k-mer rows (c, f, kmask and the hap words), GT bytes and kind,
    every row's output and each window's states."""
    alpha, _, kind, gt, state_u, smask, c, _, _, bits = args
    G, N, S = alpha.shape
    K, W, P = bits.shape[2], bits.shape[3], state_u.shape[2]
    real = int((kind == 1).sum())
    nbytes = (real * (8 * S + K * (3 + 4 * W) + gt.shape[2])
              + G * N * (4 + 4 * row_width(P)) + G * S * (4 * P + 1))
    return bound(nbytes, 0)


def check_post(where: str, args, timed: bool = True) -> dict:
    """The kernel against plain on host copies of ``args`` (alpha .. bits on
    the card), bit-identical over two runs; timed where asked."""
    G, N, S = args[0].shape
    P = args[4].shape[2]

    def run(a):
        out = torch.empty((G, N, row_width(P)), dtype=torch.int32, device=a[0].device)
        post_cuda.posterior_(out, *a)
        return out

    before = LAUNCHES["posterior"]
    out = run(args)
    torch.cuda.synchronize()
    if LAUNCHES["posterior"] != before + 1:
        fail(f"posterior {where}: not one launch a call")
    host = tuple(a.cpu() for a in args)
    t0 = time.perf_counter()
    wo = run(host).numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    go = out.cpu().numpy()
    mism = int((go[..., WINNER:] != wo[..., WINNER:]).any(axis=-1).sum())
    gpp = int((probabilities(go) != probabilities(wo)).sum())
    same = torch.equal(run(args), out)
    res = {"G": G, "N": N, "S": S, "P": P, "float_diffs": gpp,
           "fallback_rows": int((wo[..., WINNER] == -2).sum())}
    if timed:
        res["ms"] = time_ms(lambda: post_cuda.posterior_(out, *args))
        res["plain_ms"] = plain_ms
        res["bound_ms"], res["bound_by"] = post_bound(args)
    print(f"  {where}: G {G}, N {N}, S {S}, P {P}: {mism} rows differ in winner, "
          f"UK, NAK or CAK; {gpp} probabilities differ; fallback rows "
          f"{res['fallback_rows']}; two runs bit-identical {same}"
          + (f"; kernel {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
             f"({res['bound_by']}), plain {plain_ms:.1f} ms" if timed else ""))
    if mism or gpp or not same:
        fail(f"posterior {where}: the kernel differs from plain")
    return res


def phase_post(device, big_group) -> dict:
    """Phase 17; returns the cells' group's numbers, phase 14's group's
    under ``big`` and the float differences over every case (0)."""
    tp = test_torch_posterior
    done = []
    for name, kw in tp.CARD_CASES.items():
        group = [tp.make_window(50 + i, chrom=f"c{i}", **kw) for i in range(3)]
        done.append(check_post(f"case {name}", tp._tensors(tp.group_arrays(group),
                                                           device), timed=False))
    big = check_post(f"the {BIG_MB} Mb group", big_group)
    group = [tp.make_window(70 + i, chrom=f"c{i}", **POST_CELL) for i in range(4)]
    cells = tp._tensors(tp.group_arrays(group), device)
    res = check_post("the cells' group", cells)
    res["big"] = big
    res["float_diffs"] = sum(r["float_diffs"] for r in done + [big, res])
    res["full"] = post_full_group(cells)
    return res


def post_full_group(cells) -> dict:
    """The cells' group tiled to a full group of POST_FULL_G windows on the
    card: the kernel's time, the bytes of alpha and beta and of the k-mer
    inputs the engine keeps on the card for it (c, f, kmask, bits), and the
    peak allocated during the call."""
    reps = POST_FULL_G // cells[0].shape[0]
    full = tuple(t.repeat(reps, *([1] * (t.dim() - 1))) for t in cells)
    alpha, beta, kind, gt, su, sm, c, f, kmask, bits = full
    G, N, S = alpha.shape
    out = torch.empty((G, N, row_width(su.shape[2])), dtype=torch.int32,
                      device=alpha.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    post_cuda.posterior_(out, *full)
    torch.cuda.synchronize()
    res = {"G": G, "N": N, "S": S,
           "chains_bytes": 2 * alpha.numel() * 4,
           "kept_bytes": sum(t.numel() * t.element_size() for t in (c, f, kmask, bits)),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "call_bytes": torch.cuda.max_memory_allocated() - base,
           "ms": time_ms(lambda: post_cuda.posterior_(out, *full))}
    res["bound_ms"], res["bound_by"] = post_bound(full)
    print(f"  a full group, the cells' group tiled: G {G}, N {N}, S {S}: kernel "
          f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
          f"alpha and beta {res['chains_bytes'] / 2**30:.3f} GiB, the kept k-mer "
          f"inputs {res['kept_bytes'] / 2**30:.3f} GiB; peak allocated "
          f"{res['peak_bytes'] / 2**30:.3f} GiB, of it during the call "
          f"{res['call_bytes'] / 2**20:.1f} MiB")
    del full, out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 18

def prep_group(G: int, n: int, M: int, nhap: int, n_used: int, seed: int):
    """A synthetic group as the engine preps it: a table of M keys on the
    card (hap words at bit density 1/2, coverage 0-59, the cells' frequency
    mix), one chromosome's CSR of G * n nodes (0-112 rows a node, every
    100th node 128), and G windows of n nodes each with 15 top and n_used
    used haplotypes: (the card's table, its PrepTables, the CPU's
    PrepTables, nodes, top, used) with nodes, top and used on the card."""
    rng = np.random.default_rng(seed)
    Wt = (nhap + 31) // 32
    words = rng.integers(0, 1 << 32, (M, Wt), dtype=np.uint64).astype(np.uint32)
    if nhap % 32:
        words[:, -1] &= np.uint32((1 << (nhap % 32)) - 1)
    keys = np.arange(1, M + 1, dtype=np.uint64) * np.uint64(7919)
    cov = rng.integers(0, 60, M).astype(np.int32)
    freq = rng.choice([0, 1, 1, 1, 2, 5], M).astype(np.uint8)
    refflag = rng.random(M) < 0.2
    lens = rng.integers(0, 113, G * n)
    lens[::100] = 128
    off = np.zeros(G * n + 1, np.int64)
    off[1:] = np.cumsum(lens)
    idx = rng.integers(0, M, int(off[-1]))
    lp = rng.integers(0, 256, (int(off[-1]), (nhap + 7) // 8)).astype(np.uint8)
    csr = {"chr1": (off, idx, lp)}
    card = KmerTable.from_numpy(keys, cov, freq, words, refflag, nhap, "cuda")
    host = KmerTable.from_numpy(keys, cov, freq, words, refflag, nhap, "cpu")
    nodes = np.arange(G * n, dtype=np.int64).reshape(G, n)
    top = np.zeros((G, Wt), np.uint32)
    U = 32 * -(-n_used // 32)
    used = np.full((G, U), -1, np.int32)
    for g in range(G):
        for h in rng.choice(nhap, 15, replace=False):
            top[g, h >> 5] |= np.uint32(1 << (h & 31))
        used[g, :n_used] = np.sort(rng.choice(nhap, n_used, replace=False))
    return (card, PrepTables.upload(card, csr), PrepTables.upload(host, csr),
            *(torch.from_numpy(a).cuda() for a in (nodes, top.view(np.int32), used)))


def prep_bounds(tables: PrepTables, cov, nodes, U: int) -> dict[str, tuple[float, str]]:
    """The least times of the mass over one window (the engine's launch),
    of the mass over the group and of the gather: each row's index (and
    for the gather its local bytes), each distinct table entry it reads
    once (cov and freq; the hap words of the mass's counting rows, of
    every row for the gather, and the ref flag), the nodes' offsets, and
    the outputs."""
    off = tables.off.cpu().numpy()
    Wt = tables.hapbits.shape[1]
    nb = tables.lp.shape[1]
    nd = nodes.cpu().numpy()
    G, N = nd.shape
    idx = tables.idx.cpu().numpy()
    counting = ((tables.freq.cpu().numpy() == 1)
                & (np.minimum(cov.cpu().numpy(), 255) > 1))

    def mass_bytes(v):
        r = node_rows(off, v)
        t = np.unique(idx[r])
        return (16 * len(v) + 4 * len(r) + 5 * len(t)
                + 4 * Wt * int(counting[t].sum()) + 8 * tables.nhap)

    r = node_rows(off, nd.reshape(-1))
    t = np.unique(idx[r])
    gather = (16 * G * N + (4 + nb) * len(r) + (6 + 4 * Wt) * len(t)
              + G * N * (4 + prep_cuda.MAX_KMERS * (4 + 8 * U // 32)))
    return {"mass_window": bound(mass_bytes(nd[0]), 0),
            "mass_group": bound(mass_bytes(nd.reshape(-1)), 0),
            "gather": bound(gather, 0)}


def phase_prep(device) -> dict:
    """Phase 18: hap_mass and gather_rows against their plain versions at
    the cells' group and at the potato panel's widths, bit for bit and run
    to run, timed (medians of 7) beside their bytes bounds and the plain
    versions (one host run; the mass's a window, the group's over G)."""
    res = {}
    for name, shape in (("cells", PREP_CELL), ("potato", PREP_POTATO)):
        card, tables, host_tables, nodes, top, used = prep_group(**shape, seed=18)
        G, N = nodes.shape
        U = used.shape[1]
        K = prep_cuda.MAX_KMERS

        def outs(dev, g=G):
            return (*(torch.empty((g, N, K), dtype=dt, device=dev) for dt in (
                torch.uint8, torch.uint8, torch.bool, torch.bool)),
                *(torch.empty((g, N, K, U // 32), dtype=torch.int32, device=dev)
                  for _ in range(2)),
                torch.empty((g, N), dtype=torch.int32, device=dev))

        mass = torch.empty((G, shape["nhap"]), dtype=torch.int64, device=device)
        mass1 = torch.empty((1, shape["nhap"]), dtype=torch.int64, device=device)
        got = outs(device)
        before = dict(LAUNCHES)
        prep_cuda.hap_mass_(mass, nodes, tables, card.cov)
        prep_cuda.gather_rows_(*got, nodes, top, used, tables, card.cov)
        torch.cuda.synchronize()
        if (LAUNCHES["hap_mass"] != before.get("hap_mass", 0) + 1
                or LAUNCHES["gather_rows"] != before.get("gather_rows", 0) + 1):
            fail(f"prep {name}: not one launch a call")
        want_mass = torch.empty((G, shape["nhap"]), dtype=torch.int64)
        want = outs("cpu")
        t0 = time.perf_counter()
        prep_cuda.hap_mass_(want_mass, nodes.cpu(), host_tables, card.cov.cpu())
        mass_plain = (time.perf_counter() - t0) * 1e3 / G     # a window
        t0 = time.perf_counter()
        prep_cuda.gather_rows_(*want, nodes.cpu(), top.cpu(), used.cpu(),
                               host_tables, card.cov.cpu())
        gather_plain = (time.perf_counter() - t0) * 1e3
        mass_same = torch.equal(mass.cpu(), want_mass)
        diff = [int((a.cpu() != b).sum()) for a, b in zip(got, want)]
        again = outs(device)
        prep_cuda.gather_rows_(*again, nodes, top, used, tables, card.cov)
        same = all(torch.equal(a, b) for a, b in zip(again, got))
        kept = int(want[3].sum())
        r = {"G": G, "N": N, "nhap": shape["nhap"], "Ww": U // 32,
             "rows": int(tables.idx.numel()), "kept_rows": kept,
             "mass_window_ms": time_ms(lambda: prep_cuda.hap_mass_(
                 mass1, nodes[:1], tables, card.cov)),
             "mass_group_ms": time_ms(lambda: prep_cuda.hap_mass_(
                 mass, nodes, tables, card.cov)),
             "gather_ms": time_ms(lambda: prep_cuda.gather_rows_(
                 *got, nodes, top, used, tables, card.cov)),
             "mass_plain_ms": mass_plain, "gather_plain_ms": gather_plain,
             "tables_bytes": tables.nbytes()}
        for key, (ms, by) in prep_bounds(tables, card.cov, nodes, U).items():
            r[f"{key}_bound_ms"], r[f"{key}_bound_by"] = ms, by
        print(f"  {name}: G {G}, N {N}, {shape['nhap']} haplotypes, Ww {U // 32}, "
              f"{r['rows']} rows, {kept} kept; mass equal to plain {mass_same}, "
              f"gather outputs differing from plain {diff}, two runs "
              f"bit-identical {same}; hap_mass a window "
              f"{r['mass_window_ms']:.4f} ms (bound "
              f"{r['mass_window_bound_ms']:.4f}), the group "
              f"{r['mass_group_ms']:.4f} ms (bound {r['mass_group_bound_ms']:.4f}, "
              f"plain {mass_plain:.1f}); gather_rows {r['gather_ms']:.4f} ms "
              f"(bound {r['gather_bound_ms']:.4f}, plain {gather_plain:.1f}); "
              f"tables {r['tables_bytes']} bytes")
        if not mass_same or any(diff) or not same or not kept:
            fail(f"prep {name}: a kernel differs from its plain version")
        # a full group (engine_torch._WINDOW_GROUP windows, these G tiled):
        # the gather's outputs on the card, which the engine holds for a
        # group and, prepping one group ahead, for the next one too; the
        # posterior keeps c, f, kmask and bits past the emissions
        del got, want, again
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rep_g = POST_FULL_G // G
        full_in = (nodes.repeat(rep_g, 1), top.repeat(rep_g, 1),
                   used.repeat(rep_g, 1))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        full = outs(device, POST_FULL_G)
        prep_cuda.gather_rows_(*full, *full_in, tables, card.cov)
        torch.cuda.synchronize()
        r.update(
            full_G=POST_FULL_G,
            full_rows_bytes=sum(t.numel() * t.element_size() for t in full),
            full_kept_bytes=sum(full[i].numel() * full[i].element_size()
                                for i in (0, 1, 3, 4)),
            full_peak_bytes=torch.cuda.max_memory_allocated() - base,
            full_gather_ms=time_ms(lambda: prep_cuda.gather_rows_(
                *full, *full_in, tables, card.cov)))
        print(f"  {name}, a full group of {POST_FULL_G} windows: gather_rows "
              f"{r['full_gather_ms']:.3f} ms; its outputs "
              f"{r['full_rows_bytes'] / 2**30:.3f} GiB (peak above the tables "
              f"{r['full_peak_bytes'] / 2**30:.3f} GiB), of which the "
              f"posterior keeps c, f, kmask and bits "
              f"{r['full_kept_bytes'] / 2**30:.3f} GiB; with the next group "
              f"prepped ahead {2 * r['full_rows_bytes'] / 2**30:.3f} GiB")
        res[name] = r
        del card, tables, host_tables, full, full_in
        torch.cuda.empty_cache()
    return res


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

    libs = (join_cuda, cbf_cuda, fb_cuda, sketch_cuda, emit_cuda, post_cuda,
            prep_cuda)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for lib, secs in pool.map(timed_build, libs):
            print(f"  built {lib} in {secs:.2f} s")

    print("== 3. counting kernels against plain torch (tolerance: exactly "
          "equal integer counts), then timed")
    gi = load_graph(os.path.join(FIXTURE, "graph.vgt"), device=device)
    genome = read_fasta(os.path.join(FIXTURE, "ref.fa.gz"))[0]
    timings, err, err_packed, large_keys = phase_counting(device, gi, genome)

    print("== 4. main path: genotype CLI on the card")
    with tempfile.TemporaryDirectory() as work:
        cfg_path, fq = simulate_reads(work)
        counts = os.path.join(work, "counts.npz")
        cublas_before = cublas_mapped()
        LAUNCHES.clear()
        counters = timing.counters()
        with counted_plain() as calls:
            t0 = time.perf_counter()
            vcf, log_text = run_main_path("cuda", work, cfg_path, counts)
            wall = time.perf_counter() - t0
        vcf4 = vcf
        main_launches = collections.Counter(LAUNCHES)
        nbatches = check_counted_per_batch(log_text, LAUNCHES, "genotype")
        check_scoring_on_card(LAUNCHES, calls, "genotype")
        check_posterior_on_card(LAUNCHES, timing.counters_since(counters), "genotype")
        check_prep_on_card(LAUNCHES, timing.counters_since(counters), "genotype")
        m = re.search(r"\(table on (\S+)\)", log_text)
        table_dev = m.group(1) if m else "?"
        print(f"  count_packed launches {LAUNCHES['count_packed']}, batches "
              f"{nbatches}, table on {table_dev}")
        if not table_dev.startswith("cuda"):
            fail("table.cov was not on the card")
        t = phase_timings(log_text)
        print("  phase timings (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in t.items()) + f"; CLI wall {wall:.2f}")
        print(f"  the process's first genotype: emit (host: copies and enqueue) "
              f"{t['emit']:.3f} s; "
              f"libcublas mapped into the process before it: {cublas_before}, "
              f"after it: {cublas_mapped()}")
        agree, sites = gt_agreement(vcf)
        print(f"  S1 GT agrees with the truth at {agree}/{sites} sites "
              f"({agree / sites:.4f})")
        if agree < MIN_GT_AGREEMENT * sites:
            fail("GT agreement with the truth below 99%")

        print("== 5. parity on the card")
        gi = load_graph(os.path.join(FIXTURE, "graph.vgt"), device=device)
        graph2node(gi)
        count_reads(gi.table, [fq], gi.kmer_len, BATCH, READ_LEN_PAD,
                    count=plain_packed)
        plain_cov = gi.table.cov.cpu()
        read_base = load_counts(gi, counts)
        e = int((gi.table.cov.cpu() - plain_cov).abs().max())
        print(f"  coverage, packed kernel vs plain count_packed on cuda: "
              f"max_abs_err {e} over {gi.table.size} keys")
        if e:
            fail("the packed kernel and plain counted differently on the "
                 "main path")
        err_packed = max(err_packed, e)
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
        if (not LAUNCHES["cbf_add_codes"] or LAUNCHES["cbf_add"]
                or not LAUNCHES["cbf_count"] or not LAUNCHES["sketch_contexts"]):
            fail("construct did not count its genome through cbf_add_codes "
                 "and cbf_count, or its contexts through sketch_contexts")
        print_timings(construct_timings(log_text), wall)
        if compare_vgt(port_vgt, os.path.join(FIXTURE, "graph.vgt")):
            fail("the port-built graph differs from the committed JAX-built one")
        LAUNCHES.clear()
        vcf, log_text = run_main_path("cuda", work, cfg_path,
                                      os.path.join(work, "counts_port.npz"),
                                      graph=port_vgt, out_name="out_port_graph")
        main_launches.update(LAUNCHES)
        check_counted_per_batch(log_text, LAUNCHES, "genotype on the port graph")
        agree, sites = gt_agreement(vcf)
        print(f"  genotype on the port-built graph: count_packed launches "
              f"{LAUNCHES['count_packed']}; S1 GT agrees with the truth at "
              f"{agree}/{sites} sites ({agree / sites:.4f})")
        if agree < MIN_GT_AGREEMENT * sites:
            fail("genotyping the port-built graph fell below 99%")

        print("== 7. filter kernels against plain torch (tolerance: exactly "
              "equal bytes and counts)")
        cbf_err = max(check_cbf(device, genome), check_add_codes(device))
        cbf_times, e = time_cbf(device)
        cbf_err = max(cbf_err, e)

        print("== 8. main path: construct in the exact-count regime")
        exact_launches, count_codes_err = phase_exact(device, work, genome)
        main_launches.update(exact_launches)

        print(f"== 9. main path: construct at {BIG_MB} Mb on the card")
        (big_launches, e, big_ref, big_vcf, big_gi, big_vgt, big_filter,
         big_haps, big_truth, big_contexts) = phase_big(device, work)
        main_launches.update(big_launches)
        cbf_err = max(cbf_err, e)
        big_keys = big_gi.table.keys

        print(f"== 9b. main path: construct at {BIG_MB} Mb in the exact regime")
        exact_launches, e, *big_genome = phase_big_exact(
            device, work, big_ref, big_vcf, big_keys.numel())
        main_launches.update(exact_launches)
        count_codes_err = max(count_codes_err, e)

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

        print("== 13. the forward/backward kernel against plain torch "
              f"(tolerance: atol {FB_ATOL:g} on alpha/beta), then timed")
        fb120, fb465, fb_err = phase_fb(device)

        print(f"== 14. main path: genotype of the {BIG_MB} Mb graph at S = 120")
        big_launches, big_emit_group, big_post_group = phase_big_genotype(
            device, work, big_vgt, big_haps, big_truth)
        main_launches.update(big_launches)
        del big_haps

    print("== 15. the sketch kernels against plain torch (tolerance: exactly "
          "equal counts and values), then timed")
    count_codes_times, ctx_times, e, ctx_err = phase_sketch(
        device, {f"{BIG_MB} Mb table": big_keys, "24M-key": large_keys},
        big_contexts, (big_genome[1], big_genome[0]))
    count_codes_err = max(count_codes_err, e)
    del big_keys, large_keys, big_contexts, big_genome

    print("== 16. the emissions kernel against plain torch (tolerance: rtol "
          f"{EMIT_RTOL:g} on finite values, -inf and NaN at the same places), "
          "then timed")
    emit = phase_emit(device, big_emit_group)
    del big_emit_group

    print("== 17. the posterior kernel against its plain version (tolerance: "
          "none, bit for bit), then timed")
    post = phase_post(device, big_post_group)
    del big_post_group

    print("== 18. the window prep's kernels against their plain versions "
          "(tolerance: none, bit for bit), then timed")
    prep = phase_prep(device)

    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(f"  main-path launches: {dict(main_launches)}")
    source = "varigraph_tpu_torch/csrc/{}.cu"
    kernels = []
    # no single PyTorch call computes any of these kernels' functions, so
    # library_ms is null
    for name, e in (("count_join", err), ("count_packed", err_packed)):
        kms, pms, bms, by = timings["test graph"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source.format("join"),
            "replaces": "varigraph_tpu/ops/join_pallas.py:57",
            "launches": main_launches[name], "max_abs_err": e,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "on_main_path": main_launches[name] > 0,
        })
    # the exact count at a 50 Mb chromosome against phase 9's table, against
    # the 24M-key table under large_*, and on the 100 Mb genome's own first
    # chromosome against phase 9b's candidates under genome_*
    t, big, own = (count_codes_times[f"{BIG_MB} Mb table"],
                   count_codes_times["24M-key"],
                   count_codes_times[f"{BIG_MB} Mb genome's chr1 vs its candidates"])
    kernels.append({
        "name": "count_codes", "route": "cuda", "source": source.format("sketch"),
        "replaces": "varigraph_tpu/ops/exact_count.py:44",
        "fused_with": "varigraph_tpu/ops/kmer.py:79",
        "launches": main_launches["count_codes"], "max_abs_err": count_codes_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "old_path_ms": t["old_path_ms"], "large_ms": big["ms"],
        "large_plain_ms": big["plain_ms"], "large_bound_ms": big["bound_ms"],
        "large_bound_by": big["bound_by"], "large_old_path_ms": big["old_path_ms"],
        "genome_ms": own["ms"], "genome_plain_ms": own["plain_ms"],
        "genome_bound_ms": own["bound_ms"], "genome_bound_by": own["bound_by"],
        "genome_keys_hit": own["keys_hit"], "genome_windows_hit": own["windows_hit"],
    })
    bm, bm_large = (count_codes_times["bitmap"][f"{BIG_MB} Mb table"],
                    count_codes_times["bitmap"]["24M-key"])
    kernels.append({
        "name": "key_bitmap", "route": "cuda", "source": source.format("sketch"),
        "replaces": "varigraph_tpu/ops/exact_count.py:44",
        "part_of": "count_codes", "launches": main_launches["key_bitmap"],
        "max_abs_err": count_codes_err, "ms": bm["ms"], "plain_ms": bm["plain_ms"],
        "bound_ms": bm["bound_ms"], "bound_by": bm["bound_by"], "library_ms": None,
        "bits": bm["bits"], "set_share": bm["set_share"], "large_ms": bm_large["ms"],
        "large_plain_ms": bm_large["plain_ms"], "large_bound_ms": bm_large["bound_ms"],
        "large_bits": bm_large["bits"], "large_set_share": bm_large["set_share"],
    })
    kernels.append({
        "name": "sketch_contexts", "route": "cuda",
        "source": source.format("sketch"),
        "replaces": "varigraph_tpu/ops/kmer.py:79",
        "used_by": "varigraph_tpu/index/build.py:162",
        "launches": main_launches["sketch_contexts"], "max_abs_err": ctx_err,
        **ctx_times, "library_ms": None,
    })
    for name, op, line in (("cbf_add", "add", 146), ("cbf_count", "count", 162)):
        kms, pms, bms, by = cbf_times[f"{op} m=2^30"]
        sms, spms, sbms = shard_times[op]
        kernels.append({
            "name": name, "route": "cuda", "source": source.format("cbf"),
            "replaces": f"varigraph_tpu/ops/cbf.py:{line}",
            "launches": main_launches[name], "max_abs_err": cbf_err,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shard_ms": sms, "shard_plain_ms": spms,
            "shard_bound_ms": sbms, "on_main_path": main_launches[name] > 0,
        })
    # the fused genome add at the main path's shape: a whole chromosome
    kms, pms, bms, by, oms = cbf_times["add_codes chromosome m=2^30"]
    bkms, bpms, bbms, bby, boms = cbf_times["add_codes batch m=2^30"]
    kernels.append({
        "name": "cbf_add_codes", "route": "cuda", "source": source.format("cbf"),
        "replaces": "varigraph_tpu/ops/cbf.py:146",
        "fused_with": "varigraph_tpu/ops/kmer.py:79",
        "launches": main_launches["cbf_add_codes"], "max_abs_err": cbf_err,
        "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "old_path_ms": oms, "batch_ms": bkms,
        "batch_plain_ms": bpms, "batch_bound_ms": bbms,
        "batch_old_path_ms": boms, "on_main_path": main_launches["cbf_add_codes"] > 0,
    })
    kernels.append({
        "name": "forward_backward", "route": "cuda", "source": source.format("fb"),
        "replaces": "varigraph_tpu/genotype/engine_jax.py:192",
        "launches": main_launches["forward_backward"], "max_abs_err": fb_err,
        "ms": fb120["ms"], "plain_ms": fb120["plain_ms"],
        "bound_ms": fb120["bound_ms"], "bound_by": fb120["bound_by"],
        "library_ms": None, "dense_bound_ms": fb120["dense_bound_ms"],
        "fre_ms": fb120["fre_ms"], "layout_ms": fb120["layout_ms"],
        "nonzero_share": fb120["nonzero_share"],
        "modeled_wavefronts": fb120["modeled_wavefronts"],
        "s465": {k: fb465[k] for k in (
            "ms", "plain_ms", "plain_windows", "bound_ms", "bound_by",
            "dense_bound_ms", "fre_ms", "layout_ms", "nonzero_share",
            "modeled_wavefronts")},
    })
    # the 100 Mb group at S = 120, ms the bare kernel and call_ms the
    # wrapper's call; no single PyTorch call computes the emissions either
    kernels.append({
        "name": "emissions", "route": "cuda", "source": source.format("emit"),
        "replaces": "varigraph_tpu/genotype/engine_jax.py:70",
        "launches": main_launches["emissions"],
        "max_abs_err": emit["max_abs_err"], "max_rel_err": emit["max_rel_err"],
        "ms": emit["ms"], "call_ms": emit["call_ms"], "plain_ms": emit["plain_ms"],
        "bound_ms": emit["bound_ms"], "bound_by": emit["bound_by"],
        "library_ms": None,
        **{key: {k: emit[key][k] for k in (
            "S", "P", "W", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "max_rel_err")} for key in ("s465", "p4", "w2")},
    })
    # the cells' group; no single PyTorch call computes the posterior either
    kernels.append({
        "name": "posterior", "route": "cuda", "source": source.format("post"),
        "replaces": None, "launches": main_launches["posterior"],
        "float_diffs": post["float_diffs"], "ms": post["ms"],
        "plain_ms": post["plain_ms"], "bound_ms": post["bound_ms"],
        "bound_by": post["bound_by"], "library_ms": None,
        "big": {k: post["big"][k] for k in (
            "G", "N", "S", "P", "ms", "plain_ms", "bound_ms", "bound_by",
            "float_diffs")},
        "full": post["full"],
    })
    # the cells' group (the potato panel's widths under ``potato``); neither
    # replaces a TPU kernel, and no single PyTorch call computes either
    for name, key in (("hap_mass", "mass_window"), ("gather_rows", "gather")):
        kernels.append({
            "name": name, "route": "cuda", "source": source.format("prep"),
            "replaces": None, "launches": main_launches[name], "max_abs_err": 0,
            "ms": prep["cells"][f"{key}_ms"],
            "plain_ms": prep["cells"][f"{key.split('_')[0]}_plain_ms"],
            "bound_ms": prep["cells"][f"{key}_bound_ms"],
            "bound_by": prep["cells"][f"{key}_bound_by"], "library_ms": None,
            "cells": prep["cells"], "potato": prep["potato"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
