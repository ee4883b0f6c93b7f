"""The reference graph.bin format in the torch port
(varigraph_tpu_torch/index/interop.py) against the JAX package's
(varigraph_tpu/index/interop.py).

For the same graph, both write byte-identical files: at k = 27, at k = 28
(keys with bit 63 set, stored coverage in unsigned key order) and at
vcf ploidy 3 with 5 samples (16 haplotypes, where the record's bit vector is
one byte longer than the packed row and the ref-flag byte holds no haplotype
bits).  The port's load of a JAX-written file equals the JAX load in every
table array and in every node's sequences, GTs, k-mers and rebuilt local
bits; those local bits equal the ones construct computed; and genotyping
from the graph.bin gives the VCF of the .vgt."""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu.index.interop as jax_interop  # noqa: E402
from varigraph_tpu.config import VarigraphConfig as JaxConfig  # noqa: E402
from varigraph_tpu.index.build import construct_graph_index as jax_construct  # noqa: E402
from varigraph_tpu_torch.cli import main as torch_cli  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.index import interop  # noqa: E402
from varigraph_tpu_torch.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu_torch.index.serialize import load_graph, save_graph  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

CASES = {
    # name: (k, vcf ploidy, samples)
    "k27": (27, 2, ("S1", "S2")),
    "k28": (28, 2, ("S1", "S2", "S3")),
    "ploidy3": (27, 3, ("S1", "S2", "S3", "S4", "S5")),
}


@pytest.fixture(scope="module", params=list(CASES))
def built(request, tmp_path_factory):
    """Both packages' in-memory graphs of one dataset, a .vgt and the
    graph.bin each package writes."""
    name = request.param
    k, ploidy, samples = CASES[name]
    out = str(tmp_path_factory.mktemp(f"interop_{name}"))
    paths, _ = generate_dataset(out, seed=41 + k + ploidy,
                                chrom_lens={"c1": 5000, "c2": 3000},
                                n_variants=15, samples=samples, ploidy=ploidy,
                                depth=20.0)
    gi_j = jax_construct(JaxConfig(ref_file=paths["ref"], vcf_file=paths["vcf"],
                                   kmer_len=k, vcf_ploidy=ploidy, seed=0))
    gi_t = construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=k,
        vcf_ploidy=ploidy, seed=0, device="cpu"))
    files = {"vgt": os.path.join(out, "graph.vgt"),
             "jax_bin": os.path.join(out, "jax.bin"),
             "torch_bin": os.path.join(out, "torch.bin")}
    save_graph(gi_t, files["vgt"])
    jax_interop.save_reference_graph_bin(gi_j, files["jax_bin"])
    interop.save_reference_graph_bin(gi_t, files["torch_bin"])
    return name, paths, gi_j, gi_t, files


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_graph_bin_bytes_match_jax(built):
    name, _, gi_j, gi_t, files = built
    a, b = _read(files["torch_bin"]), _read(files["jax_bin"])
    assert len(a) == len(b) and a == b
    nhap = gi_t.nhap
    assert nhap == 1 + CASES[name][1] * len(CASES[name][2])
    if name == "ploidy3":
        assert nhap % 8 == 0  # bit vector (nhap >> 3) + 1 = nbytes + 1


def _node_fields(gi):
    for chrom in sorted(gi.graph.nodes):
        for node in gi.graph.nodes[chrom]:
            yield (chrom, node.start, [str(s) for s in node.seqs],
                   np.asarray(node.hap_gt, np.int64),
                   np.asarray(node.kmer_hashes, np.uint64),
                   np.asarray(node.local_bits, np.uint8))


def test_port_load_matches_jax_load(built):
    """The port's load_graph of the JAX-written graph.bin (format detected:
    not a zip) against the JAX load of the same file."""
    _, _, _, _, files = built
    t = load_graph(files["jax_bin"], device="cpu")
    j = jax_interop.load_reference_graph_bin(files["jax_bin"])
    assert (t.kmer_len, t.vcf_ploidy, t.graph_base_num, t.genome_size) == \
        (j.kmer_len, j.vcf_ploidy, j.graph_base_num, j.genome_size)
    assert t.hap_names == j.hap_names and t.chrom_lens == j.chrom_lens
    assert t.vcf_head == j.vcf_head and t.vcf_info == j.vcf_info
    np.testing.assert_array_equal(t.table.keys.numpy().view(np.uint64),
                                  j.table.keys_np())
    np.testing.assert_array_equal(t.table.cov.numpy(), np.asarray(j.table.cov))
    for view in ("keys_np", "freq_np", "hap_words_np", "refflag_np", "cov_u8"):
        np.testing.assert_array_equal(getattr(t.table, view)(),
                                      getattr(j.table, view)(), err_msg=view)
    nodes_t, nodes_j = list(_node_fields(t)), list(_node_fields(j))
    assert len(nodes_t) == len(nodes_j) > 0
    for a, b in zip(nodes_t, nodes_j):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y, err_msg=str(a[:2]))
    assert any(len(f[5]) and f[5].any() for f in nodes_t)


def test_rebuilt_local_bits_equal_construct_time(built):
    """The local bits rebuilt from a graph.bin are the ones construct
    computed and the .vgt carries."""
    _, _, _, gi_t, files = built
    back = load_graph(files["torch_bin"], device="cpu")
    nb = (gi_t.nhap + 7) // 8
    rows = 0
    for a, b in zip(_node_fields(back), _node_fields(gi_t)):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[4], b[4])
        if len(a[3]) > 1:  # variant nodes carry local bits
            np.testing.assert_array_equal(a[5].reshape(len(a[4]), nb),
                                          b[5].reshape(len(b[4]), nb),
                                          err_msg=str(a[:2]))
            rows += len(a[4])
    assert rows > 0


def test_stored_coverage_round_trips(built):
    """Nonzero coverage written into a graph.bin comes back at its keys, in
    either package, whichever wrote it."""
    name, _, gi_j, gi_t, files = built
    rng = np.random.default_rng(len(name))
    cov = rng.integers(0, 300, size=gi_t.table.size).astype(np.int32)
    gi_t.table.cov.copy_(torch.from_numpy(cov))
    path = files["torch_bin"] + ".cov"
    interop.save_reference_graph_bin(gi_t, path)
    gi_t.table.reset_cov()
    want = np.minimum(cov, 255)
    t = load_graph(path, device="cpu")
    j = jax_interop.load_reference_graph_bin(path)
    np.testing.assert_array_equal(t.table.keys_np(), gi_t.table.keys_np())
    np.testing.assert_array_equal(t.table.cov.numpy(), want)
    np.testing.assert_array_equal(np.asarray(j.table.cov), want)
    if name == "k28":
        assert (t.table.keys_np() >= np.uint64(1 << 63)).any()


def test_truncated_graph_bin_is_an_error(built, tmp_path):
    _, _, _, _, files = built
    data = _read(files["jax_bin"])
    for cut in (7, len(data) // 2):
        path = tmp_path / f"cut{cut}.bin"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="graph.bin"):
            load_graph(str(path))


def test_genotype_from_graph_bin_matches_vgt(built, tmp_path):
    """``genotype --load-graph graph.bin`` writes the VCF that
    ``--load-graph graph.vgt`` writes, with either engine."""
    _, paths, _, _, files = built
    for engine in ("torch", "np"):
        vcfs = []
        for graph in (files["vgt"], files["jax_bin"]):
            out_dir = str(tmp_path / f"{engine}_{os.path.basename(graph)}")
            assert torch_cli(["genotype", "--load-graph", graph, "-s",
                              paths["cfg"], "--device", "cpu", "--engine",
                              engine, "--out-dir", out_dir, "-t", "2"]) == 0
            with gzip.open(os.path.join(out_dir, "S1.varigraph.vcf.gz"),
                           "rt") as fh:
                vcfs.append(fh.read())
        assert vcfs[0] == vcfs[1]
        assert sum(not line.startswith("#") for line in vcfs[0].splitlines())
