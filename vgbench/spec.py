"""Where the benchmark's data files live, and how a cell's files are found
by name.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics.
Everything of one cell, configuration or per-layer metric is a file of its
own, found by its name:

  vgbench/workloads/<cell>.json    the configuration, the operation and the
                                   traffic of a cell
  vgbench/configs/<config>.json    a deployment: the panel, its source and
                                   cuts, and the genotyping settings
  vgbench/metrics/<metric>.py      a reader with ``read(ctx)`` that returns
                                   the metric's value or None
  vgbench/operations/<op>.py       what a cell's workload file names as its
                                   ``operation``: ``run(cell, seed, seconds,
                                   trace, device, layout, t_start)`` sets
                                   up, runs the window and checks it
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# caches at fixed paths inside the checkout (git-ignored): panels, graphs,
# reference tables, and each cell's run directory
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


@dataclass
class Layout:
    """The files one run reads: the benchmark file, the folders of cells,
    configurations and metrics, and the cache."""
    benchmark: str = os.path.join(ROOT, "BENCHMARK.json")
    workloads: str = os.path.join(BENCH_DIR, "workloads")
    configs: str = os.path.join(BENCH_DIR, "configs")
    metrics: str = os.path.join(BENCH_DIR, "metrics")
    operations: str = os.path.join(BENCH_DIR, "operations")
    cache: str = CACHE_DIR


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(name: str, layout: Layout | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its workload and
    configuration files, and the metrics it reports."""
    layout = layout or Layout()
    bench = _load(layout.benchmark)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell '{name}' in {layout.benchmark}")
    workload = _load(os.path.join(layout.workloads, f"{name}.json"))
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file names configuration "
                         f"'{workload['config']}', BENCHMARK.json '{entry['config']}'")
    config = _load(os.path.join(layout.configs, f"{entry['config']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in names]
    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config, end_to_end=e2e, per_layer=per_layer)


def _module(folder: str, name: str, prefix: str):
    path = os.path.join(folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"{prefix}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, layout: Layout | None = None):
    """The ``read`` function of vgbench/metrics/<name>.py."""
    return _module((layout or Layout()).metrics, name, "vgbench_metric").read


def operation(name: str, layout: Layout | None = None):
    """The module vgbench/operations/<name>.py, whose ``run`` runs a cell."""
    return _module((layout or Layout()).operations, name, "vgbench_operation")


def digest(*parts) -> str:
    """A short stable hash of JSON values and of files' bytes (paths
    prefixed with 'file:')."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, str) and p.startswith("file:"):
            with open(p[5:], "rb") as fh:
                h.update(fh.read())
        else:
            h.update(json.dumps(p, sort_keys=True).encode())
    return h.hexdigest()[:16]


def tree_files(path: str, suffixes: tuple) -> list[str]:
    """The files under ``path`` that end in ``suffixes``, sorted."""
    out = []
    for d, _, files in os.walk(path):
        if "__pycache__" in d:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(suffixes)]
    return sorted(out)
