"""A tiny copy of the benchmark's layout for the CPU tests: one diploid and
one tetraploid configuration of a few hundred sites, their cells, and the
real metric readers, with a cache of its own."""

from __future__ import annotations

import copy
import json
import os

from vgbench import spec

TINY_PANEL = {
    "ploidy": 2, "samples": 8, "site_spacing_bp": 170,
    "mix": {"snv": 0.8, "indel": 0.15, "sv": 0.05}, "indel_max_bp": 50,
    "sv_min_bp": 50, "sv_max_bp": 1500, "founders": 6, "block_sites": 40,
    "flip": 0.01,
}


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def make_layout(tmp: str, genome_mb: float = 0.06) -> spec.Layout:
    """The tiny layout under ``tmp``: each real configuration cut to
    ``genome_mb`` and a small panel, each real cell on it."""
    lay = spec.Layout(benchmark=os.path.join(tmp, "BENCHMARK.json"),
                      workloads=os.path.join(tmp, "workloads"),
                      configs=os.path.join(tmp, "configs"),
                      metrics=spec.Layout().metrics,
                      cache=os.path.join(tmp, "cache"))
    os.makedirs(lay.workloads, exist_ok=True)
    os.makedirs(lay.configs, exist_ok=True)
    bench = _load(spec.Layout().benchmark)
    for c in bench["configs"]:
        cfg = _load(os.path.join(spec.ROOT, c["file"]))
        panel = copy.deepcopy(TINY_PANEL)
        panel["ploidy"] = cfg["panel"]["ploidy"]
        panel["site_spacing_bp"] = cfg["panel"]["site_spacing_bp"]
        cfg["panel"], cfg["genome_mb"] = panel, genome_mb
        with open(os.path.join(lay.configs, f"{c['name']}.json"), "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        wl = _load(os.path.join(spec.Layout().workloads, f"{w['name']}.json"))
        wl["traffic"]["mosaic_block_sites"] = 40
        with open(os.path.join(lay.workloads, f"{w['name']}.json"), "w") as fh:
            json.dump(wl, fh)
    with open(lay.benchmark, "w") as fh:
        json.dump(bench, fh)
    return lay
