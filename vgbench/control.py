"""The control of a cell's check: the reference put in the program's place
and computed in the precision below the configuration's (bfloat16 for the
float32 the port scores in), held by the harness's own ``check`` to the
same numbers and limits as a run.  A sound check reads it as not correct.

    python -m vgbench.control --workload CELL --seeds N [N ...] [--device cuda]

prints one JSON line a seed: the numbers compared, each with its limit, and
whether the control passed.  It makes the cell's inputs as a run does, and
times nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from . import prepare, spec
from .genotype import TABLE_FIELDS, check, reference_table, score_settings
from .reference import genotype as rg


def _padded(chains: list) -> tuple:
    n = max(c[0].shape[0] for c in chains)
    s = max(c[0].shape[1] for c in chains)
    out = [np.full((len(chains), n, s), -np.inf), np.zeros((len(chains), n, s)),
           np.zeros((len(chains), n, s))]
    for w, c in enumerate(chains):
        for o, x in zip(out, c):
            o[w, : x.shape[0], : x.shape[1]] = x
    return tuple(out)


def control_numbers(cell_name: str, seed: int, device: str,
                    layout: spec.Layout | None = None, dtype=None) -> dict:
    layout = layout or spec.Layout()
    cell = spec.load_cell(cell_name, layout)
    if cell.config["genotype"]["precision"] != "float32":
        raise ValueError("the control is bfloat16, below the port's float32")
    dtype = dtype or torch.bfloat16
    man = prepare.prepare(cell_name, seed, device, layout)
    table, panel = reference_table(cell, man, layout, device)
    prog = {"seed": 0, "table": {f: getattr(table, f) for f in TABLE_FIELDS},
            "cov": {}, "cov_digests": {}, "hap_cov": {}, "calls": {}, "chains": {}}
    for s in man["samples"]:
        cov, bases = rg.count_reads(s["fastq"], table.keys, table.k, device)
        hc = rg.hap_coverage(cov, table, cell.config["panel"]["ploidy"],
                             cell.config["genotype"]["sample_ploidy"],
                             bases / len(panel.genome))
        chains = []
        calls = rg.vcf_records(rg.call_sites(table, panel, cov, hc,
                                             score_settings(cell.config), 0, dtype,
                                             device, chains))
        name = s["name"]
        prog["cov"][name], prog["cov_digests"][name] = cov, [0]
        prog["hap_cov"][name], prog["calls"][name] = [hc], [calls]
        prog["chains"][name] = _padded(chains)
    nums, _ = check(cell, man, prog, device, layout)
    limits = cell.workload["limits"]
    passed = all(math.isfinite(v) and v <= limits[k] for k, v in nums.items())
    return {"seed": seed, "dtype": str(dtype).replace("torch.", ""),
            "check": {k: {"value": v, "limit": limits[k]} for k, v in nums.items()},
            "passed": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for seed in a.seeds:
        sys.stdout.write(json.dumps(control_numbers(a.workload, seed, a.device)) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
