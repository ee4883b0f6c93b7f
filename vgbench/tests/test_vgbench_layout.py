"""Cells, configurations and metrics are found by name in their own files,
and BENCHMARK.json keeps to the shape the harness reads."""

from __future__ import annotations

import json
import os
import re

import pytest

from vgbench import spec
from vgbench.tests.tiny import make_layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(spec.Layout().benchmark) as fh:
        return json.load(fh)


def test_every_cell_config_and_metric_has_its_file():
    b = _bench()
    lay = spec.Layout()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(lay.workloads, f"{w['name']}.json"))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith(b["paths"][0] + "/")
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_names_units_and_metric_cells():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert cell.per_layer, w["name"]
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}


def test_a_cell_config_and_metric_added_as_files_are_picked_up(tmp_path):
    lay = make_layout(str(tmp_path))
    with open(lay.benchmark) as fh:
        bench = json.load(fh)
    # a new configuration, a new cell on it and a new per-layer metric
    with open(os.path.join(lay.configs, "hgsvc2_dip.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "new_cfg"
    cfg["genotype"]["haploid_num"] = 10
    with open(os.path.join(lay.configs, "new_cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(lay.workloads, "hgsvc2_dip.reads30x.json")) as fh:
        wl = json.load(fh)
    wl["config"] = "new_cfg"
    wl["traffic"]["depth"] = 5
    with open(os.path.join(lay.workloads, "new_cfg.reads5x.json"), "w") as fh:
        json.dump(wl, fh)
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    for f in os.listdir(spec.Layout().metrics):
        if f.endswith(".py"):
            (metrics / f).write_text(open(os.path.join(spec.Layout().metrics, f)).read())
    (metrics / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    lay.metrics = str(metrics)
    bench["configs"].append({"name": "new_cfg", "source": "x",
                             "file": "vgbench/configs/new_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cfg.reads5x", "config": "new_cfg",
                               "traffic": "reads5x", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "x",
                               "moves": "sample_s",
                               "workloads": ["new_cfg.reads5x"]})
    with open(lay.benchmark, "w") as fh:
        json.dump(bench, fh)
    cell = spec.load_cell("new_cfg.reads5x", lay)
    assert cell.config["genotype"]["haploid_num"] == 10
    assert cell.workload["traffic"]["depth"] == 5
    assert "new_metric" in {m["name"] for m in cell.per_layer}
    assert spec.metric_reader("new_metric", lay)(None) == 42.0
    # the old cells do not see the new metric
    old = spec.load_cell("hgsvc2_dip.reads30x", lay)
    assert "new_metric" not in {m["name"] for m in old.per_layer}


def test_an_operation_added_as_a_file_is_run(tmp_path):
    """A cell whose workload names a new operation file runs through
    run.py as it is, with the operation's own end-to-end metric."""
    from vgbench import run

    lay = make_layout(str(tmp_path))
    ops = tmp_path / "operations"
    ops.mkdir()
    (ops / "count_to_three.py").write_text(
        "def run(cell, seed, seconds, trace, device, layout, t_start):\n"
        "    return {'e2e': {'three_s': 3.0, 'setup_s': 0.5}, 'attempted': 3,\n"
        "            'failed': 0, 'checks': {'off_by': {'value': 0, 'limit': 0}},\n"
        "            'memory_peak_bytes': 0, 'kind': 'cpu'}\n")
    lay.operations = str(ops)
    with open(lay.benchmark) as fh:
        bench = json.load(fh)
    with open(os.path.join(lay.workloads, "new_op.three.json"), "w") as fh:
        json.dump({"config": "hgsvc2_dip", "operation": "count_to_three",
                   "limits": {"off_by": 0}}, fh)
    bench["workloads"].append({"name": "new_op.three", "config": "hgsvc2_dip",
                               "traffic": "three", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "three_s", "unit": "s", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["new_op.three"]})
    with open(lay.benchmark, "w") as fh:
        json.dump(bench, fh)
    r = run.run_cell("new_op.three", 1, 1.0, False, device="cpu", layout=lay)
    assert r["correct"] and r["attempted"] == 3
    assert {k: v["value"] for k, v in r["metrics"].items()} == {"three_s": 3.0,
                                                                "setup_s": 0.5}
    assert "three_s" not in {m["name"]
                             for m in spec.load_cell("hgsvc2_dip.reads30x", lay).end_to_end}


def test_each_configuration_states_its_cuts():
    """BENCHMARK.json's ``reduced`` is the configuration file's, and each key
    it names is in the file beside the source's value."""
    for c in _bench()["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert c["reduced"] == cfg["reduced"]
        for k in c["reduced"]:
            assert k in cfg and f"source_{k}" in cfg, k
            assert cfg[k] < cfg[f"source_{k}"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")
