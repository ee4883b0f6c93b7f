"""A run's check on the CPU at a tiny size: a sound run is correct; with the
timed path broken underneath (a reset that leaves the state unchanged, half
the reads left out, an answer, its posterior or GQ, or an emission altered
where it is produced)
and with the control (the reference in bfloat16 in the program's place) it
is not.  Only the look for a card is skipped."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vgbench import control, run
from vgbench.tests.tiny import make_layout

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return make_layout(str(tmp_path_factory.mktemp("vgbench")))


def _run(layout, cell="hgsvc2_dip.reads30x", trace=False):
    return run.run_cell(cell, SEED, 0.5, trace, device="cpu", layout=layout)


@pytest.mark.parametrize("cell", ["hgsvc2_dip.reads30x", "hgsvc2_dip.counts"])
def test_a_sound_run_is_correct(layout, cell):
    r = _run(layout, cell)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"sample_s", "setup_s"}
    assert list(r)[-1] == "check"


def test_a_traced_run_reads_its_layers(layout):
    r = _run(layout, trace=True)
    assert r["correct"], r["check"]
    m = r["metrics"]
    for name in ("counting_s", "coverage_s", "prep_s", "posterior_s", "vcf_s",
                 "device_idle.genotype"):
        assert name in m, name
    assert "counts_load_s" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_a_reset_that_leaves_the_counts_unchanged_fails(layout, monkeypatch):
    from varigraph_tpu_torch.ops.table import KmerTable

    monkeypatch.setattr(KmerTable, "reset_cov", lambda self: None)
    r = _run(layout)
    assert not r["correct"] and r["check"]["count_diff"]["value"] > 0


def test_half_the_reads_left_out_fails(layout, monkeypatch):
    from varigraph_tpu_torch.genotype import pipeline

    orig = pipeline.count_reads
    monkeypatch.setattr(pipeline, "count_reads",
                        lambda table, files, *a, **kw: orig(table, files[:1], *a, **kw))
    r = _run(layout)
    assert not r["correct"] and r["check"]["count_diff"]["value"] > 0


@pytest.mark.parametrize("cell", ["hgsvc2_dip.reads30x", "hgsvc2_dip.counts"])
def test_an_answer_altered_where_it_is_produced_fails(layout, monkeypatch, cell):
    from varigraph_tpu_torch.genotype import pipeline

    orig = pipeline.write_vcf

    def altered(gi, results, *a, **kw):
        nodes = {n.start: n for n in next(iter(gi.graph.nodes.values()))}
        for (_, start), rec in results.items():
            if any(nodes[start].hap_gt[h] for h in rec.hap_vec):
                rec.hap_vec = [0] * len(rec.hap_vec)   # one call turned to REF
                break
        return orig(gi, results, *a, **kw)

    monkeypatch.setattr(pipeline, "write_vcf", altered)
    r = _run(layout, cell)
    assert not r["correct"] and r["check"]["call_diff"]["value"] > 0


@pytest.mark.parametrize("fault", ["gpp", "gq"])
def test_a_posterior_altered_where_it_is_written_fails(layout, monkeypatch, fault):
    """The call stays; its GPP (and so its GQ), or its GQ alone (off by 5),
    is wrong."""
    from varigraph_tpu_torch.genotype import pipeline, vcfout

    if fault == "gpp":
        orig = pipeline.write_vcf

        def altered(gi, results, *a, **kw):
            nodes = {n.start: n for n in next(iter(gi.graph.nodes.values()))}
            for (_, start), rec in results.items():
                if any(nodes[start].hap_gt[h] for h in rec.hap_vec):
                    rec.probability *= 0.5          # a normalisation gone wrong
                    break
            return orig(gi, results, *a, **kw)

        monkeypatch.setattr(pipeline, "write_vcf", altered)
    else:
        orig = vcfout.cal_phred_scaled
        monkeypatch.setattr(vcfout, "cal_phred_scaled", lambda p: orig(p) - 5.0)
    r = _run(layout)
    assert not r["correct"]
    assert r["check"]["gq_gap"]["value"] > r["check"]["gq_gap"]["limit"]
    assert (r["check"]["gpp_diff"]["value"] > 0) == (fault == "gpp")
    assert r["check"]["call_diff"]["value"] == 0


def test_an_emission_altered_where_it_is_produced_fails(layout, monkeypatch):
    from varigraph_tpu_torch.genotype import engine_torch

    orig = engine_torch.emissions_

    def altered(out, *a):
        orig(out, *a)
        out.mul_(1.001)

    monkeypatch.setattr(engine_torch, "emissions_", altered)
    r = _run(layout)
    assert not r["correct"] and r["check"]["emit_gap"]["value"] > r["check"]["emit_gap"]["limit"]


def test_the_control_is_not_correct(layout):
    c = control.control_numbers("hgsvc2_dip.reads30x", SEED, "cpu", layout)
    assert c["dtype"] == "bfloat16"
    assert not c["passed"], c["check"]
    assert c["check"]["emit_gap"]["value"] > 10 * c["check"]["emit_gap"]["limit"]


def test_the_control_at_the_stated_precision_passes(layout):
    c = control.control_numbers("hgsvc2_dip.reads30x", SEED, "cpu", layout,
                                dtype=torch.float32)
    assert c["passed"], c["check"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lay = make_layout(str(tmp_path))
    for trace in (False, True):
        r = run.run_cell("hgsvc2_dip.reads30x", SEED, 1.0, trace, device="cuda",
                         layout=lay)
        assert r["correct"], r["check"]
        assert r["device"]["platform"] == "gpu"
        if trace:
            assert r["device"]["busy_s"] > 0
            assert "fb_roofline" in r["metrics"]
            assert 0 < r["metrics"]["fb_roofline"]["value"] <= 105
    assert np.isfinite(r["device"]["memory_peak_bytes"])
