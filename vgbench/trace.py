"""The traced window: ``torch.profiler`` over the window, reduced to the
device's busy time (the union of its kernel, copy and set intervals, not
their sum), each operation's device seconds, and the idle gaps, each named
by the phase the host was in (from the program's log lines).

The profiler's clock is tied to the host's ``time.perf_counter`` by a
marker recorded at the window's start, so every interval is in the host
clock's seconds.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start(cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    with record_function("vgbench.mark"):
        prof.vg_mark = time.perf_counter()
    return prof


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def stop(prof, t0: float, t1: float, run_dir: str) -> dict:
    """Busy seconds, window seconds, device seconds by operation name and
    the idle gaps of the window [t0, t1] (host clock)."""
    prof.__exit__(None, None, None)
    path = os.path.join(run_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    mark = next(e for e in events if e.get("name") == "vgbench.mark")
    off = mark["ts"] / 1e6 - prof.vg_mark
    ivals, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = e["ts"] / 1e6 - off
        b = a + e.get("dur", 0) / 1e6
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        ivals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy = union(ivals)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    return {"busy_s": sum(b - a for a, b in busy), "window_s": t1 - t0,
            "op_s": by_name, "gaps": gaps}


def kernel_seconds(data: dict, *names: str) -> float:
    """Device seconds of the operations whose name holds one of ``names``."""
    return sum(s for op, s in data["op_s"].items() if any(n in op for n in names))


def phase_at(spans: list[dict], t: float) -> str:
    for sp in spans:
        if sp["t0"] <= t <= sp["t1"]:
            for name, (a, b) in sp.get("phases", {}).items():
                if a <= t <= b:
                    return name
            return "sample"
    return "between samples"


def breakdown(data: dict, spans: list[dict]) -> dict:
    ops = sorted(data["op_s"].items(), key=lambda x: -x[1])[:10]
    gaps = sorted(data["gaps"], key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[phase_at(spans, (a + b) / 2), b - a] for a, b in gaps]}
