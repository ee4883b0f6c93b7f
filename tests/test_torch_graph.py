"""The construct building blocks of the torch port against the JAX package:
the VCF -> graph builder and the context walker (index/graph.py), the forked
context collection, genome segmentation and the context sketch
(index/build.py), and the host k-mer helpers (ops/kmer.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu.index.build as jax_build  # noqa: E402
import varigraph_tpu.index.graph as jax_graph  # noqa: E402
import varigraph_tpu.ops.kmer as jax_kmer  # noqa: E402
import varigraph_tpu_torch.index.build as torch_build  # noqa: E402
import varigraph_tpu_torch.index.graph as torch_graph  # noqa: E402
import varigraph_tpu_torch.ops.kmer as torch_kmer  # noqa: E402
import varigraph_tpu_torch.ops.sketch as torch_sketch  # noqa: E402
from varigraph_tpu.ops.sketch_ref import sketch_ref  # noqa: E402

from data_gen import make_genome, make_vcf  # noqa: E402


def _dataset(seed, lens, n_var, samples=("S1", "S2", "S3"), indel=0.3):
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, lens)
    vcf, _ = make_vcf(genome, rng, n_variants_per_chrom=n_var, samples=samples,
                      indel_frac=indel)
    return genome, vcf.splitlines(keepends=True)


def _build(mod, genome, lines, ploidy=2):
    return mod.build_graph_from_vcf(iter(lines), genome, ploidy)


def _assert_same_graph(t, j):
    tg, jg = t[0], j[0]
    # vcf head, vcf mirror, haplotype names, stats, extra ALT bases
    assert (t[1], t[2], t[3], vars(t[4]), t[5]) == (
        j[1], j[2], j[3], vars(j[4]), j[5])
    assert tg.chroms == jg.chroms
    for c in jg.chroms:
        assert tg.starts[c] == jg.starts[c]
        for a, b in zip(tg.nodes[c], jg.nodes[c]):
            assert [str(s) for s in a.seqs] == [str(s) for s in b.seqs]
            np.testing.assert_array_equal(a.hap_gt, b.hap_gt)
        for dense in ("starts_np", "ends_np", "gt_mat", "gt_len"):
            np.testing.assert_array_equal(getattr(tg, dense)[c],
                                          getattr(jg, dense)[c])


# A VCF with the cases the builder handles specially: a duplicate site, an
# unsorted site, a REF that disagrees with the FASTA, a missing GT, a haploid
# GT, a multi-allelic site and overlapping deletions.
EDGE_FASTA = {"chr1": "ACGTACGTACGTACGTACGTACGTAAAATTTTTTTCCCCGGGG" * 3,
              "chr2": "TTGCA" * 20}
EDGE_VCF = [
    "##fileformat=VCFv4.2\n",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n",
    "chr1\t5\t.\tA\tT\t30\t.\t.\tGT\t0/1\t1|1\n",
    "chr1\t5\t.\tA\tC\t30\t.\t.\tGT\t1/1\t0/0\n",
    "chr1\t3\t.\tG\tC\t30\t.\t.\tGT\t1/1\t0/1\n",
    "chr1\t10\t.\tC\tCAAA,G\t30\t.\t.\tGT\t1/2\t.\n",
    "chr1\t20\t.\tT\tA\t30\t.\t.\tGT:DP\t1:7\t0/1:3\n",
    "chr1\t26\t.\tAAATTTTTTT\tA\t30\t.\t.\tGT\t0/1\t1/0\n",
    "chr1\t28\t.\tAT\tA\t30\t.\t.\tGT\t1/1\t0/1\n",
    "chr1\t31\t.\tG\tC\t30\t.\t.\tGT\t1/0\t1/1\n",
    "chr2\t7\t.\tG\tGT\t30\t.\t.\tGT\t0/1\t1/1\n",
]


def test_graph_builder_edge_cases_match_jax():
    t = _build(torch_graph, EDGE_FASTA, EDGE_VCF)
    j = _build(jax_graph, EDGE_FASTA, EDGE_VCF)
    _assert_same_graph(t, j)
    assert t[2] == j[2]  # vcf mirror, skipped records included


@pytest.mark.parametrize("ploidy", [2, 3])
def test_graph_builder_matches_jax_on_generated_vcf(ploidy):
    genome, lines = _dataset(3, {"c1": 4000, "c2": 3000}, 25)
    _assert_same_graph(_build(torch_graph, genome, lines, ploidy),
                       _build(jax_graph, genome, lines, ploidy))


def test_walker_matches_jax_for_every_haplotype():
    genome, lines = _dataset(4, {"c1": 3000}, 60, indel=0.5)
    tg = _build(torch_graph, genome, lines)[0]
    jg = _build(jax_graph, genome, lines)[0]
    k = 27
    walks = 0
    for c in jg.chroms:
        for idx, node in enumerate(jg.nodes[c]):
            if not node.is_variant:
                continue
            for h in range(len(node.hap_gt)):
                gt = int(node.hap_gt[h])
                tu, td, ju, jd = [], [], [], []
                got = torch_graph.find_node_up_down_seq(
                    h, gt, tg.nodes[c][idx].seqs[gt], k - 1, idx, tg.starts[c],
                    tg.nodes[c], trace_up=tu, trace_down=td)
                want = jax_graph.find_node_up_down_seq(
                    h, gt, node.seqs[gt], k - 1, idx, jg.starts[c], jg.nodes[c],
                    trace_up=ju, trace_down=jd)
                assert tuple(map(str, got)) == tuple(map(str, want))
                assert (tu, td) == (ju, jd)
                walks += 1
    assert walks > 100


def test_walker_snp_inside_deletion():
    """The reference's own example (construct_index.cpp:1406-1428)."""
    fasta = {"chr1": "AAAA" + "TTTTTTT" + "CCCC"}
    lines = EDGE_VCF[:2] + [
        "chr1\t5\t.\tTTTTTTT\tT\t30\t.\t.\tGT\t0/1\t0/0\n",
        "chr1\t6\t.\tT\tA\t30\t.\t.\tGT\t1/1\t0/0\n",
    ]
    graph = _build(torch_graph, fasta, lines)[0]
    starts, nodes = graph.starts["chr1"], graph.nodes["chr1"]
    idx = starts.index(5)
    up, down, alt = torch_graph.find_node_up_down_seq(
        1, 0, nodes[idx].seqs[0], 4, idx, starts, nodes)
    assert (up, down, alt) == ("AAAA", "CCCC", "TATTTTT")


@pytest.mark.parametrize("fast", [False, True])
def test_collect_contexts_matches_jax(fast):
    genome, lines = _dataset(6, {"c1": 5000, "c2": 2000}, 30)
    k = 27
    t = torch_build.collect_contexts(_build(torch_graph, genome, lines)[0], k, 2,
                                     fast)
    j = jax_build.collect_contexts(_build(jax_graph, genome, lines)[0], k, 2, fast)
    assert [(c, i) for c, i, _ in t[0]] == [(c, i) for c, i, _ in j[0]]
    assert t[1] == j[1]
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)


def test_segment_genome_batches_matches_jax():
    """The port cuts the genome into the JAX package's rows arithmetically
    (ops/cbf.genome_rows, genome_row_codes); here at 40 columns, against
    the JAX batches of 8 rows, whose last one is padded with rows of 4."""
    from varigraph_tpu_torch.ops.cbf import genome_row_codes, genome_rows
    from varigraph_tpu_torch.ops.sketch_ref import encode_bases_np

    rng = np.random.default_rng(0)
    for k in (15, 27, 28):
        seq = "".join(rng.choice(list("ACGTN"), size=1003,
                                 p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        j = np.concatenate(list(jax_build.segment_genome_batches(
            seq, k, rows=8, cols=40)))
        rows = genome_rows(len(seq), k, cols=40)
        t = genome_row_codes(torch.from_numpy(encode_bases_np(seq)), k, 0,
                             rows, cols=40).numpy()
        assert len(j) == -(-rows // 8) * 8 > 8
        np.testing.assert_array_equal(t, j[:rows])
        assert (j[rows:] == 4).all()


def test_sketch_contexts_matches_jax(monkeypatch):
    """Per-context unique k-mers in unsigned order, whatever the batching:
    lengths 0 to 300, N runs, and k = 28 values with bit 63 set."""
    # small JAX batches: the same per-context output, smaller CPU compiles
    monkeypatch.setattr(jax_build, "_CTX_BATCH_AREA", 4096)
    rng = np.random.default_rng(2)
    lens = [0, 5, 27, 28, 64, 65, 129, 300] + list(rng.integers(28, 200, 40))
    ctxs = ["".join(rng.choice(list("ACGTN"), size=int(n),
                               p=[0.245, 0.245, 0.245, 0.245, 0.02]))
            for n in lens]
    for k in (27, 28):
        want = jax_build._sketch_contexts(ctxs, k)
        for area in (1 << 23, 1000):
            monkeypatch.setattr(torch_sketch, "CTX_BATCH_AREA", area)
            got = torch_build._sketch_contexts(ctxs, k)
            for g, w, s in zip(got, want, ctxs):
                assert g.dtype == np.uint64
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(
                    g, np.unique(np.array(sketch_ref(s, k), np.uint64)))
        if k == 28:
            assert any((w >= np.uint64(1 << 63)).any() for w in want)


def test_kmer_host_helpers_match_jax():
    seqs = ["ACGTNACGT", "", "acgtu" * 7, "GATTACA" * 9]
    np.testing.assert_array_equal(torch_kmer.encode_bases(seqs[2]),
                                  jax_kmer.encode_bases(seqs[2]))
    for s in seqs:
        for k in (5, 27, 28):
            got = torch_kmer.sketch_seq(s, k)
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, jax_kmer.sketch_seq(s, k))
