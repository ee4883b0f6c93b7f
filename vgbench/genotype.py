"""The genotype operations (``operations/genotype_reads.py``,
``operations/genotype_counts.py``): set-up, window and check of a cell that
genotypes samples, as the CLI's ``genotype`` does.

Set-up: a process of its own makes the inputs (``vgbench.prepare``); this
process then loads the graph and genotypes each of its two samples once, so
that the window finds every library loaded and every shape warm.  The
window genotypes the two samples in turn, whole samples back to back, for
``seconds`` seconds, and finishes the one in flight (``sample_s`` = the
window's time over the samples it completed).  With ``trace`` the window
runs under ``torch.profiler``.  After the window the reference
(``reference/``) works out the table, the counts, the coverage model, the
emissions, the forward/backward and the calls again, and ``check`` sets
each number compared beside its limit (the cell's workload file).
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

from . import bounds, spec, trace as tracing


class LogTap:
    """Stands in for sys.stderr: keeps each line the program logs with the
    host clock's time at which it was written."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._buf = ""
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        t = time.perf_counter()
        with self._lock:
            self._buf += s
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                self.lines.append((t, line))
        return len(s)

    def flush(self) -> None:
        pass

    def between(self, t0: float, t1: float) -> list[tuple[float, str]]:
        return [(t, s) for t, s in self.lines if t0 <= t <= t1]


def run_prepare(cell: str, seed: int, device: str, layout: spec.Layout) -> dict:
    cmd = [sys.executable, "-m", "vgbench.prepare", "--workload", cell,
           "--seed", str(seed), "--device", device,
           "--layout", json.dumps(layout.__dict__)]
    r = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"prepare failed ({r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ program hooks

class Capture:
    """Wraps the engine's forward/backward (and, in a traced run, its
    emissions call) to keep what the window's kernels produced for the
    check, and the arguments the kernels' bounds are worked out from."""

    def __init__(self, engine, traced: bool):
        self.engine = engine
        self.current = None
        self.chains: dict[str, tuple] = {}
        self.fb_calls: list[tuple] = []
        self.emit_calls: list[tuple] = []
        self._fb = engine._forward_backward
        self._emit = engine.emissions_

        def fb(logE, kind, lrf, lnrf, lrb, lnrb, overlap, log_w, smask, fre, P):
            alpha, beta = self._fb(logE, kind, lrf, lnrf, lrb, lnrb, overlap,
                                   log_w, smask, fre, P)
            self.chains[self.current] = (logE, alpha, beta)
            if self.recording:
                self.fb_calls.append((tuple(logE.shape), kind, overlap, smask, fre))
            return alpha, beta

        def emit(out, c, f, flag, kmask, bits, local, gt0, state_u, smask, *sc):
            self._emit(out, c, f, flag, kmask, bits, local, gt0, state_u, smask, *sc)
            if self.recording:
                self.emit_calls.append(bounds.emit_work(
                    out, c, f, flag, kmask, bits, local, gt0, state_u, smask))

        self.recording = False
        engine._forward_backward = fb
        if traced:
            engine.emissions_ = emit

    def restore(self) -> None:
        self.engine._forward_backward = self._fb
        self.engine.emissions_ = self._emit

    def bounds(self) -> dict:
        """Seconds the window's emissions and forward/backward launches
        could take at least (``bounds.py``)."""
        emit = sum(bounds.emit_bound_s(nb, float(tr), P)
                   for nb, tr, P in self.emit_calls)
        fb = sum(bounds.fb_bound_s(shape, kind.cpu().numpy(), overlap.cpu().numpy(),
                                   smask.cpu().numpy())
                 for shape, kind, overlap, smask, fre in self.fb_calls if not fre)
        return {"emissions": emit if self.emit_calls else None,
                "fb": fb if self.fb_calls else None}


def _phases(tap: LogTap, t0: float, t1: float) -> dict:
    """A sample's phases from the program's log lines between t0 and t1."""
    marks = {"counting": None, "coverage model": None, "scoring": None,
             "vcf write": None}
    out = {"t0": t0, "t1": t1, "engine": {}, "hap_cov": None}
    for t, s in tap.between(t0, t1):
        m = re.search(r"phase timing: (counting|coverage model|scoring|vcf write) ", s)
        if m:
            marks[m.group(1)] = t
        m = re.search(r"engine timing: prep ([\d.]+)s assemble ([\d.]+)s emit "
                      r"([\d.]+)s fb ([\d.]+)s posterior ([\d.]+)s", s)
        if m:
            out["engine"] = dict(zip(("prep", "assemble", "emit", "fb", "posterior"),
                                     map(float, m.groups())))
        m = re.search(r"peak_hom: \d+; peak_hap: ([\d.eE+-]+)", s)
        if m:
            out["hap_cov"] = float(m.group(1))
    seq = [t0, marks["counting"], marks["coverage model"], marks["scoring"],
           marks["vcf write"], t1]
    names = ("counting", "coverage", "scoring", "vcf", "between")
    out["phases"] = {n: (a, b) for n, a, b in zip(names, seq[:-1], seq[1:])
                     if a is not None and b is not None}
    return out


# ---------------------------------------------------------------- the check

TABLE_FIELDS = ("keys", "freq", "flag", "bits", "node_start", "tbl_off",
                "tbl_idx", "tbl_lp")


def _prog_table(gi) -> dict:
    from varigraph_tpu_torch.ops.table import unpack_hapbits

    chrom = next(iter(gi.graph.nodes))
    off, idx, lp = gi.graph.tbl_csr[chrom]
    bits = np.packbits(unpack_hapbits(gi.table.hap_words_np(), gi.nhap),
                       axis=1, bitorder="little")
    return {"keys": gi.table.keys_np().copy(), "freq": gi.table.freq_np().copy(),
            "flag": gi.table.refflag_np().copy(), "bits": bits,
            "node_start": gi.graph.starts_np[chrom].copy(), "tbl_off": off.copy(),
            "tbl_idx": idx.copy(), "tbl_lp": lp.copy()}


def reference_table(cell, man: dict, layout: spec.Layout, device):
    """The reference's table of the cell's panel, cached by the panel and
    the reference's sources."""
    from .reference import table as rt

    cfg = cell.config
    key = spec.digest(os.path.basename(man["panel_dir"]), cfg["genotype"]["k"],
                      *("file:" + f for f in spec.tree_files(
                          os.path.join(spec.BENCH_DIR, "reference"), (".py",))))
    path = os.path.join(layout.cache, "reftable", f"{cfg['name']}-{key}.npz")
    panel = rt.read_panel(man["fasta"], man["vcf"], cfg["panel"]["ploidy"])
    if os.path.exists(path):
        return rt.load_table(path), panel
    t = rt.build_table(panel, cfg["genotype"]["k"], device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rt.save_table(t, path + ".tmp.npz")
    os.replace(path + ".tmp.npz", path)
    return t, panel


def score_settings(config: dict) -> dict:
    g = config["genotype"]
    return {"haploid_num": g["haploid_num"], "sample_type": g["sample_type"],
            "sample_ploidy": g["sample_ploidy"], "mode": g["mode"],
            "granularity_bp": int(round(g["granularity_mb"] * 1_000_000))}


def check(cell, man, prog: dict, device, layout: spec.Layout) -> tuple[dict, dict]:
    """(numbers compared, {(sample, i): whether the window's i-th output
    of that sample failed}).

    prog is what the timed path produced: ``seed`` (the port's scoring
    seed), ``table`` (TABLE_FIELDS), and by sample name ``cov`` (the last
    counts), ``cov_digests`` (a digest of each pass's counts), ``hap_cov``
    (each pass's coverage model), ``calls`` (each pass's calls, as
    ``reference.genotype.read_vcf_calls`` reads a VCF) and ``chains`` (the
    last group's logE, alpha and beta)."""
    import torch

    from .reference import compare
    from .reference import genotype as rg

    table, panel = reference_table(cell, man, layout, device)
    nums = {"table_diff": compare.table_diff(prog["table"], table),
            "count_diff": 0, "hap_cov_gap": 0.0, "call_diff": 0, "kmer_diff": 0,
            "gpp_diff": 0, "gq_gap": 0.0, "emit_gap": 0.0, "chain_gap": 0.0}
    limits = cell.workload["limits"]
    bad = {}
    for s in man["samples"]:
        name = s["name"]
        if name not in prog["cov"]:          # not in the window
            continue
        cov, bases = rg.count_reads(s["fastq"], table.keys, table.k, device)
        cd = compare.count_diff(prog["cov"][name], cov)
        cd += sum(1 for d in prog["cov_digests"][name][:-1]
                  if d != prog["cov_digests"][name][-1])
        hc = rg.hap_coverage(cov, table, cell.config["panel"]["ploidy"],
                             cell.config["genotype"]["sample_ploidy"],
                             bases / len(panel.genome))
        hg = max((abs(h - hc) if h is not None else math.inf)
                 for h in prog["hap_cov"][name])
        chains = []
        want = rg.vcf_records(rg.call_sites(
            table, panel, cov, hc, score_settings(cell.config), prog["seed"],
            torch.float64, device, chains))
        cg = compare.chain_gaps(chains, *prog["chains"][name])
        nums["count_diff"] += cd
        nums["hap_cov_gap"] = max(nums["hap_cov_gap"], hg)
        nums["emit_gap"] = max(nums["emit_gap"], cg["emit_gap"])
        nums["chain_gap"] = max(nums["chain_gap"], cg["chain_gap"])
        for i, calls in enumerate(prog["calls"][name]):
            g = compare.call_gaps(want, calls)
            site = g.pop("gq_site")
            if site and (i == 0 or g["gq_gap"] > limits["gq_gap"]):
                sys.stderr.write(f"vgbench: {name} output {i}: widest GQ gap {g['gq_gap']} "
                                 f"at site {site[0]}: reference {site[1]!r}, "
                                 f"compared {site[2]!r}\n")
            for k, v in g.items():
                nums[k] = max(nums[k], v)
            bad[(name, i)] = bool(any(v > limits[k] for k, v in g.items()) or cd or hg)
    return nums, bad


# -------------------------------------------------------------------- a run

def _genotype_config(config: dict, device: str):
    from varigraph_tpu_torch.config import VarigraphConfig

    g = config["genotype"]
    s = score_settings(config)
    return VarigraphConfig(sample_type=s["sample_type"],
                           sample_ploidy=s["sample_ploidy"],
                           haploid_num=s["haploid_num"],
                           granularity_bp=s["granularity_bp"],
                           transition_pro_type=s["mode"], device=device,
                           threads=int(g.get("threads", 10)))


def window(cell, seed: int, seconds: float, trace: bool, device: str,
           layout: spec.Layout, t_start: float, counts: bool) -> dict:
    """One run of a genotype cell; returns what ``run.py`` makes the result
    of (see ``run.run_cell``).  counts: genotype from the counts a
    ``--save-counts`` pass saved in set-up, not from the reads."""
    import torch

    man = run_prepare(cell.name, seed, device, layout)

    from varigraph_tpu_torch.genotype import engine_torch
    from varigraph_tpu_torch.genotype.engine_np import graph2node
    from varigraph_tpu_torch.genotype.pipeline import genotype_one_sample
    from varigraph_tpu_torch.index.serialize import load_graph

    from .reference import genotype as rg

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = _genotype_config(cell.config, device)
    samples = man["samples"]
    run_dir = man["run_dir"]
    tap = LogTap()
    real_err = sys.stderr
    cap = Capture(engine_torch, trace)
    wgen = torch.Generator().manual_seed(12345)
    prog = {"seed": cfg.seed, "cov": {}, "cov_digests": {}, "hap_cov": {},
            "calls": {}, "chains": {}}
    spans: list[dict] = []

    def one(gi, s, tag, record):
        cap.current = s["name"]
        t0 = time.perf_counter()
        vcf = genotype_one_sample(gi, cfg, s["name"], s["fastq"],
                                  os.path.join(run_dir, tag),
                                  counts_in=s["counts"] if counts else None)
        snap = gi.table.cov.clone()
        digest = (snap.to(torch.int64) * weights).sum()
        gi.table.reset_cov()
        t1 = time.perf_counter()
        if record:
            prog["cov"][s["name"]] = snap
            prog["cov_digests"].setdefault(s["name"], []).append(digest)
            spans.append({"sample": s["name"], "vcf": vcf, "t0": t0, "t1": t1})
        return t1

    sys.stderr = tap
    try:
        gi = load_graph(man["graph"], device=cfg.torch_device(), threads=cfg.threads)
        cfg.kmer_len, cfg.vcf_ploidy = gi.kmer_len, gi.vcf_ploidy
        graph2node(gi)
        weights = torch.randint(1, 1 << 20, (gi.table.size,), generator=wgen
                                ).to(gi.table.device)
        for j, s in enumerate(samples):             # both samples' shapes
            one(gi, s, f"warm{j}", False)
        sync()
        prof = tracing.start(cuda) if trace else None
        cap.recording = True
        cpu0 = time.process_time()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        i = 0
        while True:
            t1 = one(gi, samples[i % 2], f"w{i:03d}", True)
            i += 1
            if t1 - t_w0 >= seconds:
                break
        sync()
        t_w1 = time.perf_counter()
        cpu1 = time.process_time()
        cap.recording = False
        trace_data = tracing.stop(prof, t_w0, t_w1, run_dir) if trace else None
    finally:
        sys.stderr = real_err
        cap.restore()
        with open(os.path.join(run_dir, "program.log"), "w") as fh:
            fh.writelines(f"{t - t_start:10.4f} {s}\n" for t, s in tap.lines)
    window_s = t_w1 - t_w0
    mem = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    for sp in spans:
        sp.update(_phases(tap, sp["t0"], sp["t1"]))
        prog["hap_cov"].setdefault(sp["sample"], []).append(sp["hap_cov"])
        sp["index"] = len(prog["calls"].setdefault(sp["sample"], []))
        prog["calls"][sp["sample"]].append(rg.read_vcf_calls(sp["vcf"]))

    # what the window produced, to the host; then the program's state goes
    prog["table"] = _prog_table(gi)
    for k in list(prog["cov"]):
        prog["cov"][k] = prog["cov"][k].cpu().numpy()
        prog["cov_digests"][k] = [int(d) for d in prog["cov_digests"][k]]
    for k, (le, a, b) in cap.chains.items():
        prog["chains"][k] = tuple(x.float().cpu().numpy() for x in (le, a, b))
    kernel_bounds = cap.bounds() if trace else None
    del gi, cap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_r0 = time.perf_counter()
    nums, bad = check(cell, man, prog, device, layout)
    sys.stderr.write(f"vgbench: {cell.name} window {window_s:.2f} s, {len(spans)} "
                     f"samples; check {time.perf_counter() - t_r0:.2f} s; process cpu "
                     f"{cpu1 - cpu0:.2f} s in the window\n")
    limits = cell.workload["limits"]
    # a sample failed when its own VCF, counts or coverage differ, or when
    # a number that holds for every sample (the table, the chains) does
    common = any(nums[k] > limits[k] for k in ("table_diff", "emit_gap", "chain_gap"))
    failed = sum(1 for sp in spans
                 if common or bad.get((sp["sample"], sp["index"]), True))
    return {"e2e": {"sample_s": window_s / len(spans), "setup_s": setup_s},
            "attempted": len(spans), "failed": failed,
            "checks": {k: {"value": v, "limit": limits[k]} for k, v in nums.items()},
            "memory_peak_bytes": mem, "kind": kind, "trace": trace_data,
            "spans": spans,
            "ctx": SimpleNamespace(cell=cell, operation=cell.workload["operation"],
                                   samples=spans, device=trace_data,
                                   bounds=kernel_bounds)}
