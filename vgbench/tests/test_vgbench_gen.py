"""The generators keep each configuration's shapes: site density, the mix of
SNVs, indels and SVs, ploidy and haplotype count, a sample that is a mosaic
of panel haplotypes, and reads with the stated depth and error rate."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest

from vgbench import spec
from vgbench.gen import panel as gen


def _config(name: str, mb: float) -> dict:
    with open(os.path.join(spec.Layout().configs, f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["genome_mb"] = mb
    return cfg


@pytest.mark.parametrize("name", ["hgsvc2_dip", "potato_tet4"])
def test_panel_keeps_the_configuration_shapes(name):
    cfg = _config(name, 0.5 if name == "hgsvc2_dip" else 0.1)
    p = cfg["panel"]
    panel = gen.make_panel(cfg)
    glen = len(panel.genome)
    n = len(panel.pos)
    spacing = (glen - 2 * gen.SITE_MARGIN) / n
    assert abs(spacing - p["site_spacing_bp"]) < 0.15 * p["site_spacing_bp"]
    assert panel.gt.shape == (n, p["samples"] * p["ploidy"])
    assert panel.ploidy == p["ploidy"]
    alen = np.array([len(a) for a in panel.alts])
    size = np.maximum(alen, panel.ref_len) - 1
    snv = (alen == 1) & (panel.ref_len == 1)
    sv = size >= p["sv_min_bp"]
    assert abs(snv.mean() - p["mix"]["snv"]) < 0.02
    assert abs(sv.mean() - p["mix"]["sv"]) < 0.01
    assert size[~snv & ~sv].max() < p["indel_max_bp"]
    # sorted, not overlapping, a reference base between sites
    assert np.all(panel.pos[1:] > panel.pos[:-1] + panel.ref_len[:-1])
    # an ALT keeps the anchor base, a SNV changes it
    for i in np.flatnonzero(snv)[:200]:
        assert panel.alts[i] != panel.ref_allele(i)
    for i in np.flatnonzero(~snv)[:200]:
        assert panel.alts[i][:1] == panel.ref_allele(i)[:1]
    # the same data seed, the same panel
    again = gen.make_panel(cfg)
    assert np.array_equal(again.gt, panel.gt) and np.array_equal(again.pos, panel.pos)


def test_sample_is_a_mosaic_of_panel_haplotypes():
    cfg = _config("hgsvc2_dip", 0.3)
    panel = gen.make_panel(cfg)
    tr = {"private_snv_rate": 0.0, "mosaic_block_sites": 50}
    haps = gen.make_sample(panel, np.random.default_rng(5), tr)
    assert len(haps) == panel.ploidy
    # every haplotype equals the spliced sequence of some panel haplotype
    # over each block: rebuild it from the generator's own draw
    rng = np.random.default_rng(5)
    rng.binomial(len(panel.genome), 0.0)
    rng.integers(0, len(panel.genome), size=0)
    rng.integers(1, 4, size=0)
    for h in haps:
        src = gen._blocks(rng, len(panel.pos), 50.0, panel.nhap)
        assert len(np.unique(src)) > 1
        want = gen.haplotype_sequence(panel, panel.gt[np.arange(len(panel.pos)), src])
        assert np.array_equal(h, want)


def test_reads_have_the_depth_and_error_rate():
    cfg = _config("hgsvc2_dip", 0.2)
    panel = gen.make_panel(cfg)
    tr = {"depth": 30, "read_len": 150, "error_rate": 0.005,
          "private_snv_rate": 1e-4, "mosaic_block_sites": 300}
    rng = np.random.default_rng(9)
    hap = gen.haplotype_sequence(panel, np.zeros(len(panel.pos), np.uint8))
    reads = gen.simulate_reads([hap, hap], len(panel.genome), rng, tr)
    assert reads.shape == (round(len(panel.genome) * 30 / 2 / 150) * 2, 150)
    assert set(np.unique(reads)) <= set(b"ACGT")
    # forward reads against the sequence they were cut from
    rng = np.random.default_rng(9)
    starts = rng.integers(0, len(hap) - 150, size=reads.shape[0] // 2)
    rc = rng.random(reads.shape[0] // 2) < 0.5
    assert 0.3 < rc.mean() < 0.7
    # the same seed, the same reads
    again = gen.simulate_reads([hap, hap], len(panel.genome), np.random.default_rng(9), tr)
    assert np.array_equal(again, reads)
    # the error rate: reads matching the haplotype somewhere differ in ~0.5%
    seq = hap.tobytes()
    fwd = [r.tobytes() for r in reads[:3000]]
    exact = sum(1 for r in fwd if r in seq or r.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1] in seq)
    assert 0.3 < exact / len(fwd) < 0.65     # (1 - 0.005)^150 = 0.47


def test_fastq_round_trip(tmp_path):
    from vgbench.reference.genotype import read_fastq

    rng = np.random.default_rng(1)
    reads = gen.BASES[rng.integers(0, 4, size=(1000, 150))]
    paths = [str(tmp_path / f"r{i}.fq.gz") for i in range(2)]
    gen.write_fastq(reads, paths)
    got = []
    for p in paths:
        codes, offs = read_fastq(p)
        got.append(codes.reshape(-1, 150))
    assert np.array_equal(np.concatenate(got), np.searchsorted(np.frombuffer(b"ACGT", np.uint8), reads))
