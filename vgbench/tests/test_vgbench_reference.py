"""The reference equals the port on tiny panels, on the CPU: the sketch, the
table and the nodes' k-mer lists (diploid and tetraploid), the counts, the
coverage model, the emissions, the forward/backward and the calls."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from vgbench.gen import panel as gen
from vgbench.reference import compare
from vgbench.reference import genotype as rg
from vgbench.reference.kmers import segment_kmers
from vgbench.reference.table import build_table, read_panel
from vgbench.tests.tiny import TINY_PANEL


@pytest.mark.parametrize("k", [5, 27, 28])
def test_sketch_equals_the_ports_plain_sketch(k):
    from varigraph_tpu_torch.ops.kmer import sketch_codes

    rng = np.random.default_rng(k)
    seqs = [rng.integers(0, 4, size=n).astype(np.uint8)
            for n in (1, k - 1, k, k + 1, 40, 150, 700)]
    seqs += [np.array([0, 3] * 60, np.uint8), np.zeros(90, np.uint8),
             np.array([0, 1, 2, 3] * 40, np.uint8)]
    codes = np.concatenate(seqs)
    off = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    vals, seg = segment_kmers(torch.from_numpy(codes), torch.from_numpy(off), k,
                              chunk=300)
    for i, s in enumerate(seqs):
        v, e = sketch_codes(torch.from_numpy(s[None, :]), k)
        assert torch.equal(v[e], vals[seg == i])


def _panel(tmp, ploidy, spacing, mb=0.05, samples=8):
    cfg = {"data_seed": 3, "genome_mb": mb,
           "panel": dict(copy.deepcopy(TINY_PANEL), ploidy=ploidy,
                         site_spacing_bp=spacing, samples=samples)}
    fa, vcf = gen.write_panel(gen.make_panel(cfg), str(tmp))
    return cfg, fa, vcf


def _port_graph(fa, vcf, ploidy):
    from varigraph_tpu_torch.config import VarigraphConfig
    from varigraph_tpu_torch.index.build import construct_graph_index

    return construct_graph_index(VarigraphConfig(
        ref_file=fa, vcf_file=vcf, vcf_ploidy=ploidy, device="cpu", threads=1))


@pytest.mark.parametrize("ploidy,spacing", [(2, 170), (2, 40), (4, 24)])
def test_table_equals_the_ports_construct(tmp_path, ploidy, spacing):
    from vgbench.genotype import _prog_table

    _, fa, vcf = _panel(tmp_path, ploidy, spacing)
    gi = _port_graph(fa, vcf, ploidy)
    t = build_table(read_panel(fa, vcf, ploidy), 27)
    assert len(t.keys) > 1000
    assert compare.table_diff(_prog_table(gi), t) == 0


def test_counts_coverage_chains_and_calls_equal_the_ports(tmp_path):
    from varigraph_tpu_torch.config import VarigraphConfig
    from varigraph_tpu_torch.genotype import engine_torch
    from varigraph_tpu_torch.genotype.pipeline import genotype_one_sample

    cfg, fa, vcf = _panel(tmp_path, 2, 170, mb=0.1, samples=12)
    panel = gen.make_panel(cfg)
    rng = np.random.default_rng(4)
    tr = {"depth": 30, "read_len": 150, "error_rate": 0.005,
          "private_snv_rate": 1e-4, "mosaic_block_sites": 40}
    reads = gen.simulate_reads(gen.make_sample(panel, rng, tr), len(panel.genome), rng, tr)
    fq = [str(tmp_path / f"s_{i}.fq.gz") for i in range(2)]
    gen.write_fastq(reads, fq)

    gi = _port_graph(fa, vcf, 2)
    got = {}
    orig = engine_torch._forward_backward

    def keep(logE, *a):
        alpha, beta = orig(logE, *a)
        got["chains"] = (logE.numpy().copy(), alpha.numpy().copy(), beta.numpy().copy())
        return alpha, beta

    engine_torch._forward_backward = keep
    try:
        out = genotype_one_sample(gi, VarigraphConfig(device="cpu", threads=2), "S",
                                  fq, str(tmp_path / "out"))
    finally:
        engine_torch._forward_backward = orig
    t = build_table(read_panel(fa, vcf, 2), 27)
    cov, bases = rg.count_reads(fq, t.keys, 27, "cpu")
    assert compare.count_diff(gi.table.cov.numpy(), cov) == 0
    hc = rg.hap_coverage(cov, t, 2, 2, bases / len(panel.genome))
    chains = []
    sc = {"haploid_num": 15, "sample_type": "het", "sample_ploidy": 2,
          "granularity_bp": 1_000_000, "mode": "rec"}
    want = rg.vcf_records(rg.call_sites(t, read_panel(fa, vcf, 2), cov, hc, sc, 0,
                                        torch.float64, "cpu", chains))
    assert len(want) > 100
    g = compare.call_gaps(want, rg.read_vcf_calls(out))
    assert not any(g.values()), g
    c = compare.chain_gaps(chains, *got["chains"])
    assert c["emit_gap"] < 1e-5 and c["chain_gap"] < 1e-4
