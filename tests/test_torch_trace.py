"""The port's recorder of spans and counters (varigraph_tpu_torch/utils/timing.py)
and the spans and counters the genotype path records with it.

The recorder: nesting and parent ids, a parent handed to a worker thread,
the ring's bound and what it drops, counters (the kernel launch counters
among them) under threads, and its cost.  The native reader's own clocks
and counts.  A CPU genotype of a data_gen dataset: each sample's span tree,
the counting counters against what they count, the posterior's counters, the log lines the benchmark
and the smoke read, and the shared clock with the profiler's trace through
the benchmark's mark.
"""

import ast
import gzip
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.genotype.counting import count_reads  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import graph2node, make_windows  # noqa: E402
from varigraph_tpu_torch.genotype.pipeline import genotype_one_sample  # noqa: E402
from varigraph_tpu_torch.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu_torch.index.serialize import load_graph, save_graph  # noqa: E402
from varigraph_tpu_torch.native.loader import get_fastq_lib  # noqa: E402
from varigraph_tpu_torch.ops import cuda_build, sketch_cuda  # noqa: E402
from varigraph_tpu_torch.utils import timing  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("phase.counting", "phase.coverage", "phase.scoring", "phase.vcf")


def _closed_since(mark: int) -> list:
    return [sp for sp in timing.spans() if sp.id > mark]


def _mark() -> int:
    with timing.span("test.mark") as sp:
        pass
    return sp.id


# ------------------------------------------------------------- recorder

def test_nested_spans_record_parent_trace_thread_and_clock():
    t = time.perf_counter()
    with timing.span("a", x=1) as a:
        assert timing.current() is a
        with timing.span("b") as b:
            time.sleep(0.001)
        with timing.span("c") as c:
            pass
    assert timing.current() is None
    assert (a.parent, a.trace) == (None, a.id)
    assert (b.parent, b.trace, c.parent, c.trace) == (a.id, a.id, a.id, a.id)
    assert len({a.id, b.id, c.id}) == 3
    assert a.thread == b.thread == threading.current_thread().name
    assert t <= a.t0 <= b.t0 < b.t1 <= c.t0 <= c.t1 <= a.t1 <= time.perf_counter()
    assert b.seconds >= 0.001 and a.attrs == {"x": 1}
    got = timing.spans()[-3:]
    assert [sp.name for sp in got] == ["b", "c", "a"]    # in the order closed


def test_a_parent_is_handed_to_a_worker_thread():
    def work():
        with timing.span("w", parent=root) as w:
            with timing.span("w.child") as child:
                pass
        with timing.span("loose") as loose:
            pass
        return w, child, loose

    with ThreadPoolExecutor(max_workers=1) as pool:
        with timing.span("root") as root:
            w, child, loose = pool.submit(work).result(timeout=30)
    assert (w.parent, w.trace) == (root.id, root.id)
    assert (child.parent, child.trace) == (w.id, root.id)
    assert (loose.parent, loose.trace) == (None, loose.id)
    assert w.thread != root.thread and child.thread == w.thread
    assert root.t0 <= w.t0 <= child.t0 <= child.t1 <= w.t1 <= root.t1


def test_the_ring_keeps_the_newest_spans():
    first = _mark()
    t = time.perf_counter()
    for i in range(timing.RING_SPANS + 10):
        with timing.span("ring", i=i):
            pass
    got = timing.spans()
    assert len(got) == timing.RING_SPANS
    assert all(sp.id > first for sp in got)
    assert [sp.attrs["i"] for sp in got[-2:]] == [timing.RING_SPANS + 8,
                                                   timing.RING_SPANS + 9]
    # it holds every span that closed after its oldest one did: the "ring"
    # spans from i = 10
    assert got[0].attrs["i"] == 10 and t < timing.held_since() == got[0].t1


def test_counters_hold_every_group_and_count_under_threads():
    assert cuda_build.LAUNCHES is timing.counter_group("launches")
    assert sketch_cuda.LONG_ROUTE is timing.counter_group("long_route")
    before = timing.counters()
    cuda_build.LAUNCHES["test_kernel"] += 2
    sketch_cuda.LONG_ROUTE["test_contexts"] += 1
    timing.count("test.seconds", 0.5)

    n_threads, n_each = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [timing.count("test.adds")
                                                    for _ in range(n_each)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    moved = timing.counters_since(before)
    assert moved == {"launches.test_kernel": 2, "long_route.test_contexts": 1,
                     "test.seconds": 0.5, "test.adds": n_threads * n_each}
    assert timing.counters()["launches.test_kernel"] == cuda_build.LAUNCHES["test_kernel"]


def test_a_span_costs_at_most_two_microseconds():
    us = timing.span_cost_us()
    assert us <= 2.0, f"{us:.2f} us a span"


# ------------------------------------------------- the genotype path

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("trace"))
    paths, _ = generate_dataset(out, seed=11, chrom_lens={"chr1": 9000, "chr2": 6000},
                                n_variants=24, samples=("S1", "S2"), depth=20.0)
    gi = construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0,
        device="cpu"))
    path = os.path.join(out, "graph.vgt")
    save_graph(gi, path)
    # the reads in two gzip files, as a sample's pair
    with gzip.open(paths["fq"], "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    fqs = []
    for i, part in enumerate((lines[: len(lines) // 8 * 4], lines[len(lines) // 8 * 4:])):
        fq = os.path.join(out, f"reads_{i}.fq.gz")
        with gzip.open(fq, "wb") as fh:
            fh.writelines(part)
        fqs.append(fq)
    return {"out": out, "graph": path, "fqs": fqs, "reads": len(lines) // 4}


@pytest.fixture(scope="module")
def genotyped(dataset):
    """Two samples genotyped in turn, as the CLI does, in windows of 2 kb
    scored two a group; the spans, the log and each sample's name."""
    from vgbench.genotype import LogTap

    cfg = VarigraphConfig(device="cpu", granularity_bp=2000, threads=2)
    mark = _mark()
    gi = load_graph(dataset["graph"], device="cpu")
    cfg.kmer_len, cfg.vcf_ploidy = gi.kmer_len, gi.vcf_ploidy
    graph2node(gi)
    tap, err = LogTap(), sys.stderr
    group = et._WINDOW_GROUP
    et._WINDOW_GROUP = 2
    sys.stderr = tap
    try:
        bounds = []
        for name in ("A", "B"):
            t0 = time.perf_counter()
            genotype_one_sample(gi, cfg, name, dataset["fqs"],
                                os.path.join(dataset["out"], "vcf"))
            gi.table.reset_cov()
            bounds.append((name, t0, time.perf_counter()))
    finally:
        sys.stderr = err
        et._WINDOW_GROUP = group
    windows = sum(len(make_windows(gi.graph.starts[c], gi.chrom_lens[c], 2000))
                  for c in gi.graph.nodes)
    return {"spans": _closed_since(mark), "tap": tap, "bounds": bounds,
            "windows": windows}


def test_each_sample_has_one_span_tree(genotyped):
    spans = genotyped["spans"]
    by_id = {sp.id: sp for sp in spans}
    samples = [sp for sp in spans if sp.name == "sample"]
    assert [sp.attrs["sample"] for sp in samples] == ["A", "B"]
    for s in samples:
        mine = [sp for sp in spans if sp.trace == s.id]
        names = [sp.name for sp in mine]
        assert names.count("sample") == 1 and len(mine) <= 1000
        for p in PHASES:
            (phase,) = [sp for sp in mine if sp.name == p]
            assert phase.parent == s.id and s.t0 <= phase.t0 <= phase.t1 <= s.t1
        scoring = next(sp for sp in mine if sp.name == "phase.scoring")
        preps = [sp for sp in mine if sp.name == "prep.window"]
        posts = [sp for sp in mine if sp.name == "post.window"]
        assert len(preps) == genotyped["windows"] > 2
        assert len(posts) == sum(1 for sp in preps if sp.attrs["nodes"] > 0) > 2
        for w in preps + posts:
            assert w.parent == scoring.id and w.thread != s.thread
            assert scoring.t0 <= w.t0 <= w.t1 <= scoring.t1
        for child, window in (("prep.select", "prep.window"),
                              ("prep.gather", "prep.window"),
                              ("post.records", "post.window")):
            kids = [sp for sp in mine if sp.name == child]
            assert len(kids) == len([sp for sp in mine if sp.name == window])
            for k in kids:
                w = by_id[k.parent]
                assert w.name == window and w.t0 <= k.t0 <= k.t1 <= w.t1
        # on the main thread: the waits and each group's steps in scoring;
        # the feed's spans on the reader threads, under the counting phase
        for name in ("engine.wait_prep", "engine.wait_post", "group.assemble",
                     "group.emit", "group.fb"):
            assert any(sp.name == name and sp.parent == scoring.id for sp in mine), name
        counting = next(sp for sp in mine if sp.name == "phase.counting")
        feed = ("feed.batch", "feed.open") if get_fastq_lib() else ("feed.batch",)
        for name in ("count.feed_wait", "count.stage") + feed:
            got = [sp for sp in mine if sp.name == name]
            assert got and all(sp.parent == counting.id for sp in got), name
            assert all(counting.t0 <= sp.t0 <= sp.t1 <= counting.t1 for sp in got)
        assert all(sp.thread != s.thread for sp in mine if sp.name == "feed.batch")
        waits = [sp for sp in mine if sp.name == "count.feed_wait"]
        stages = [sp for sp in mine if sp.name == "count.stage"]
        assert len(waits) == len(stages) + 1


def test_the_sample_span_holds_its_counters(genotyped, dataset):
    for s in (sp for sp in genotyped["spans"] if sp.name == "sample"):
        c = s.attrs["counters"]
        assert c["count.reads"] == dataset["reads"]
        assert 0 < c["count.hits"] <= c["count.kmers"]
        assert c["count.batches"] >= 2 and c["count.bases"] > 0
        if get_fastq_lib():                     # the native reader's clocks
            assert c["feed.inflate_s"] > 0 and c["feed.pack_s"] > 0


def test_the_sample_span_counts_the_posteriors_path(genotyped):
    """On the CPU each window's posterior goes through the plain version:
    the sample's counters count every window, and no record from the card."""
    spans = genotyped["spans"]
    for s in (sp for sp in spans if sp.name == "sample"):
        c = s.attrs["counters"]
        posts = [sp for sp in spans if sp.trace == s.id and sp.name == "post.window"]
        assert c["post.plain_windows"] == len(posts) > 2
        for name in ("post.card_nodes", "post.fallback_nodes", "launches.posterior"):
            assert name not in c, name


def test_the_counting_counters_match_what_they_count(dataset):
    gi = load_graph(dataset["graph"], device="cpu")
    before = timing.counters()
    bases = count_reads(gi.table, dataset["fqs"], gi.kmer_len, 256, 160, io_threads=2)
    moved = timing.counters_since(before)
    assert moved["count.bases"] == bases > 0
    assert moved["count.hits"] == int(gi.table.cov.sum()) > 0
    assert moved["count.hits"] <= moved["count.kmers"]
    assert moved["count.reads"] == dataset["reads"]
    assert moved["count.batches"] > 2


@pytest.fixture(scope="module")
def small_fastq_gz(tmp_path_factory):
    """3,000 reads of 20-400 bases with N among them, gzipped."""
    path = str(tmp_path_factory.mktemp("stats") / "reads.fq.gz")
    rng = np.random.default_rng(3)
    with gzip.open(path, "wt") as fh:
        for i in range(3000):
            n = int(rng.integers(20, 400))      # some longer than a row holds
            r = "".join(rng.choice(list("ACGTN"), size=n))
            fh.write(f"@read{i} extra\n{r}\n+\n{'I' * n}\n")
    return path


@pytest.mark.parametrize("whole_max", [None, "10"], ids=["whole_file", "zlib_stream"])
def test_the_native_reader_counts_its_clocks_reads_and_kmers(small_fastq_gz, whole_max,
                                                               monkeypatch):
    """The port's reader counts its inflate and parse-and-pack seconds, its
    reads and the k-mer windows it packed: a read's ACGT runs of n >= K
    bases hold n - K + 1 each."""
    import ctypes
    import re

    B, L, K = 256, 160, 27
    lib = get_fastq_lib()
    if lib is None:
        pytest.skip("no C++ toolchain")
    if whole_max is not None:
        monkeypatch.setenv("VGF_WHOLE_MAX", whole_max)
    with gzip.open(small_fastq_gz, "rt") as fh:
        seqs = fh.read().splitlines()[1::4]
    want = sum(len(r) - K + 1 for s in seqs for r in re.findall("[ACGT]+", s)
               if len(r) >= K)
    h = lib.vgf_open(small_fastq_gz.encode())
    try:
        buf = np.zeros((B, L // 4 + 2), np.uint8)
        bases = ctypes.c_long(0)
        while lib.vgf_next_batch_packed(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), B, L, K,
                ctypes.byref(bases)):
            buf[:] = 0
        inflate, pack = ctypes.c_double(0), ctypes.c_double(0)
        reads, kmers = ctypes.c_long(0), ctypes.c_long(0)
        lib.vgf_stats(h, ctypes.byref(inflate), ctypes.byref(pack),
                      ctypes.byref(reads), ctypes.byref(kmers))
    finally:
        lib.vgf_close(h)
    assert reads.value == len(seqs) == 3000
    assert kmers.value == want > 0
    assert inflate.value > 0 and pack.value > 0


def _chip_smoke_engine_timing() -> str:
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "ENGINE_TIMING"
                for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no ENGINE_TIMING")


def test_the_log_lines_match_their_readers(genotyped):
    import re

    from vgbench.genotype import _phases

    tap = genotyped["tap"]
    spans = genotyped["spans"]
    for (name, t0, t1), s in zip(genotyped["bounds"],
                                 [sp for sp in spans if sp.name == "sample"]):
        got = _phases(tap, t0, t1)
        assert set(got["phases"]) == {"counting", "coverage", "scoring", "vcf",
                                      "between"}, got
        assert set(got["engine"]) == {"prep", "assemble", "emit", "fb", "posterior"}
        # each phase line is written as its span closes
        for phase, key in zip(PHASES, ("counting", "coverage", "scoring", "vcf")):
            sp = next(x for x in spans if x.name == phase and x.trace == s.id)
            written = got["phases"][key][1]
            assert sp.t1 <= written <= sp.t1 + 0.05, phase
        lines = [line for t, line in tap.between(t0, t1) if "engine timing:" in line]
        assert len(lines) == 1 and re.search(_chip_smoke_engine_timing(), lines[0])
        assert lines[0].endswith("(non-overlapped)")
        waited = sum(sp.seconds for sp in spans
                     if sp.name == "engine.wait_prep" and sp.trace == s.id)
        assert abs(got["engine"]["prep"] - waited) <= 0.006


def test_a_span_and_the_profiler_share_the_clock(tmp_path):
    from vgbench import trace

    a = torch.rand(384, 384)
    # the process's first record_function takes ~1 ms between its timestamp
    # and its body, where trace.start reads the clock; warmed here, so that
    # what is held is the mapping of the two clocks
    with torch.profiler.record_function("test.warm"):
        pass
    prof = trace.start(False)
    try:
        time.sleep(0.002)
        with timing.span("test.op") as sp:
            torch.mm(a, a)
        time.sleep(0.002)
    finally:
        prof.__exit__(None, None, None)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    mark = next(e for e in events if e.get("name") == "vgbench.mark")
    off = mark["ts"] / 1e6 - prof.vg_mark
    (mm,) = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    t0 = mm["ts"] / 1e6 - off
    t1 = t0 + mm["dur"] / 1e6
    assert sp.t0 - 1e-3 <= t0 <= t1 <= sp.t1 + 1e-3, (sp.t0, t0, t1, sp.t1)
