"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 -m vgbench.run --workload CELL --seed N --seconds S --trace 0|1

The cell's workload file names its operation, a file of its own,
``operations/<operation>.py``, whose ``run`` makes the cell's inputs, sets
up and warms up, runs the window for ``--seconds`` seconds and checks what
the window produced against the plain reference (``reference/``).  This
file makes the result of what it returns: the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics (each read by
``metrics/<name>.py``), the device, and ``correct``: every number compared
within its limit.

The last line on standard output is the result's JSON object; the last lines
on standard error name each number compared with its limit.  Without a CUDA
card (or with fewer than the cell asks for) the run prints no result and
exits with 3; with the JAX package or JAX loaded once the window closed,
with 4.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from . import spec, trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "varigraph_tpu")


class NoChip(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", layout: spec.Layout | None = None) -> dict:
    """The result of one run of cell ``name``.  The operation's ``run``
    returns ``e2e`` (end-to-end values by metric name), ``attempted``,
    ``failed``, ``checks`` ({number: {value, limit}}), ``memory_peak_bytes``,
    ``kind`` (the device's name), and for a traced run ``trace``
    (``trace.stop``'s reduction), ``spans`` (the window's operations, each
    with ``t0``, ``t1`` and its ``phases``) and ``ctx`` (what the per-layer
    readers read)."""
    layout = layout or spec.Layout()
    cell = spec.load_cell(name, layout)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NoChip(f"{name} needs {cell.chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    op = spec.operation(cell.workload["operation"], layout)
    out = op.run(cell, seed, seconds, trace, device, layout, _T0)

    checks = out["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": out["kind"],
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], layout)(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = tracing.breakdown(out["trace"], out["spans"])
    else:
        result["metrics"] = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in out["e2e"]}
        result["device"] = dev
    result["check"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoChip as e:
        sys.stderr.write(f"vgbench: {e}\n")
        return 3
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"vgbench: the run loaded {', '.join(found)}\n")
        return 4
    for k, c in result["check"].items():
        sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.write(f"correct {result['correct']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
