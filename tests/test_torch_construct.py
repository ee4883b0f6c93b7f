"""``construct`` in the torch port against the JAX package.

``python -m varigraph_tpu_torch construct ... --device cpu`` must write a .vgt
whose every member equals the one ``python -m varigraph_tpu construct`` writes
for the same inputs: table keys, freq, bits and refflag, the graph2node CSR
(tc_*), kmer_flat, local_bits, gt_flat, seq_blob and the rest, and the parsed
``meta``.  That holds in the Bloom-filter regime and in the exact-count
regime (``_CBF_DEVICE_MAX`` forced to 1 in both packages), at k = 27 and
k = 28 (whose encodings set bit 63), with --fast and --use-unique-kmers, and
with a forked -t 4 context walk.  The committed 2 Mb fixture, built by the
JAX package, is rebuilt bit for bit."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu.index.build as jax_build  # noqa: E402
import varigraph_tpu_torch.index.build as torch_build  # noqa: E402
from varigraph_tpu.cli import main as jax_cli  # noqa: E402
from varigraph_tpu.index.serialize import load_graph as jax_load  # noqa: E402
from varigraph_tpu_torch.cli import main as torch_cli  # noqa: E402
from varigraph_tpu_torch.index.serialize import load_graph as torch_load  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "slice2m")


def assert_same_vgt(path_a: str, path_b: str) -> None:
    """Every npz member equal in dtype, shape and value; meta compared as
    parsed JSON (the zip bytes carry timestamps)."""
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            x, y = a[name], b[name]
            if name == "meta":
                assert json.loads(bytes(x)) == json.loads(bytes(y))
                continue
            assert x.dtype == y.dtype, name
            assert x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _construct(cli, paths, out, *extra):
    args = ["construct", "-r", paths["ref"], "-v", paths["vcf"],
            "--save-graph", out, *extra]
    if cli is torch_cli:
        args += ["--device", "cpu"]
    assert cli(args) == 0
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_construct"))
    paths, _ = generate_dataset(out, seed=5, chrom_lens={"c1": 6000, "c2": 4000},
                                n_variants=20, samples=("S1", "S2", "S3"),
                                depth=0.5)
    return paths


CASES = {
    "k27": (["-k", "27"], False),
    "k28": (["-k", "28"], False),
    "fast": (["-k", "27", "--fast"], False),
    "unique_kmers": (["-k", "27", "--use-unique-kmers"], False),
    "exact_k27": (["-k", "27"], True),
    "exact_k28": (["-k", "28"], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_construct_vgt_matches_jax(case, dataset, tmp_path, monkeypatch):
    extra, exact = CASES[case]
    if exact:  # both packages take the exact-count regime
        from varigraph_tpu.ops.exact_count import ExactGenomeCounter

        monkeypatch.setattr(jax_build, "_CBF_DEVICE_MAX", 1)
        monkeypatch.setattr(torch_build, "_CBF_DEVICE_MAX", 1)
        # one genome batch per JAX dispatch: the same counts, a smaller
        # compile on the CPU
        monkeypatch.setattr(ExactGenomeCounter, "ADD_STACK", 1)
    extra = [*extra, "--seed", "3"]
    a = _construct(torch_cli, dataset, str(tmp_path / "torch.vgt"), *extra)
    b = _construct(jax_cli, dataset, str(tmp_path / "jax.vgt"), *extra)
    assert_same_vgt(a, b)
    with np.load(a) as z:
        keys = z["tbl_keys"]
        assert len(keys) > 0 and (keys[1:] > keys[:-1]).all()
        assert (z["tbl_freq"] >= 1).all()
        if "k28" in case:
            assert (keys >= np.uint64(1 << 63)).any()


def test_regime_switch_and_exact_counts(dataset, monkeypatch):
    """make_genome_cbf keeps the filter up to _CBF_DEVICE_MAX cells and
    counts exactly above; exact counts are the true multiplicities, which
    the filter's never undercut."""
    from varigraph_tpu_torch.io.fasta import read_fasta
    from varigraph_tpu_torch.ops.cbf import CountingBloomFilter
    from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter
    from varigraph_tpu_torch.ops.kmer import sketch_seq

    fasta, _, size = read_fasta(dataset["ref"])
    bf = torch_build.make_genome_cbf(fasta, size, 27, 0)
    assert isinstance(bf, CountingBloomFilter)
    monkeypatch.setattr(torch_build, "_CBF_DEVICE_MAX", bf.size)
    assert isinstance(torch_build.make_genome_cbf(fasta, size, 27, 0),
                      CountingBloomFilter)
    monkeypatch.setattr(torch_build, "_CBF_DEVICE_MAX", bf.size - 1)
    ec = torch_build.make_genome_cbf(fasta, size, 27, 0)
    assert isinstance(ec, ExactGenomeCounter)

    kmers, counts = np.unique(
        np.concatenate([sketch_seq(s, 27) for s in fasta.values()]),
        return_counts=True)
    exact = ec.count(kmers)
    np.testing.assert_array_equal(exact, np.minimum(counts, 255))
    assert (bf.count(kmers) >= exact).all()


def test_threaded_walk_matches_serial_and_jax(tmp_path):
    """-t 4 forks the context walk (>= 256 variant nodes); the .vgt equals
    the -t 1 one and the JAX package's."""
    paths, _ = generate_dataset(str(tmp_path), seed=17,
                                chrom_lens={"chr1": 60000}, n_variants=300,
                                samples=("S1", "S2"), depth=0.2)
    t4 = _construct(torch_cli, paths, str(tmp_path / "t4.vgt"), "-t", "4")
    t1 = _construct(torch_cli, paths, str(tmp_path / "t1.vgt"), "-t", "1")
    assert_same_vgt(t4, t1)
    assert_same_vgt(t4, _construct(jax_cli, paths, str(tmp_path / "jax.vgt"),
                                   "-t", "1"))


def test_port_vgt_loads_in_both_packages(dataset, tmp_path):
    a = _construct(torch_cli, dataset, str(tmp_path / "torch.vgt"))
    b = _construct(jax_cli, dataset, str(tmp_path / "jax.vgt"))
    ja, jb = jax_load(a), jax_load(b)
    for view in ("keys_np", "freq_np", "hap_words_np", "refflag_np"):
        np.testing.assert_array_equal(getattr(ja.table, view)(),
                                      getattr(jb.table, view)())
    assert ja.hap_names == jb.hap_names and ja.vcf_info == jb.vcf_info
    for c in jb.graph.chroms:
        for x, y in zip(ja.graph.kmer_csr[c], jb.graph.kmer_csr[c]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(ja.graph.tbl_csr[c], jb.graph.tbl_csr[c]):
            np.testing.assert_array_equal(x, y)
    ta = torch_load(a, device="cpu")
    np.testing.assert_array_equal(ta.table.keys.numpy().view(np.uint64),
                                  jb.table.keys_np())
    assert ta.graph_base_num == jb.graph_base_num


def test_in_memory_index_matches_its_saved_file(dataset, tmp_path):
    from varigraph_tpu_torch.config import VarigraphConfig
    from varigraph_tpu_torch.index.serialize import save_graph

    gi = torch_build.construct_graph_index(VarigraphConfig(
        ref_file=dataset["ref"], vcf_file=dataset["vcf"], device="cpu"))
    assert gi.table.keys.device.type == "cpu" and gi.table.cov.dtype == torch.int32
    path = str(tmp_path / "g.vgt")
    save_graph(gi, path)
    back = torch_load(path)
    np.testing.assert_array_equal(back.table.keys_np(), gi.table.keys_np())
    np.testing.assert_array_equal(back.table.hap_words_np(), gi.table.hap_words_np())
    for c in gi.graph.chroms:
        for x, y in zip(back.graph.tbl_csr[c], gi.graph.tbl_csr[c]):
            np.testing.assert_array_equal(x, y)
    gi.graph.tbl_csr.clear()  # save_graph never recomputes graph2node
    with pytest.raises(ValueError, match="graph2node"):
        save_graph(gi, str(tmp_path / "no_csr.vgt"))


def test_committed_fixture_rebuilt_bit_for_bit(tmp_path):
    """tools/make_torch_fixture.py built graph.vgt with the JAX package from
    these inputs (k = 27, seed 0); the port rebuilds the same file."""
    out = str(tmp_path / "graph.vgt")
    assert torch_cli(["construct", "-r", os.path.join(FIXTURE, "ref.fa.gz"),
                      "-v", os.path.join(FIXTURE, "vars.vcf.gz"), "-k", "27",
                      "--seed", "0", "--device", "cpu", "--save-graph", out,
                      "-t", "2"]) == 0
    assert_same_vgt(out, os.path.join(FIXTURE, "graph.vgt"))


def test_cuda_without_a_card_is_an_error(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(ValueError, match="no CUDA device"):
        torch_cli(["construct", "-r", dataset["ref"], "-v", dataset["vcf"],
                   "--device", "cuda", "--save-graph", str(tmp_path / "g.vgt")])
    assert not os.path.exists(tmp_path / "g.vgt")


@pytest.mark.parametrize("k", [27, 28])
def test_genome_filter_of_an_n_bearing_fasta_matches_jax(k, tmp_path):
    """make_genome_cbf on a FASTA with N runs, lower-case bases and a
    chromosome shorter than a row: the port's filter (add_codes a
    chromosome) equals the JAX package's (its batches through its sketch)."""
    from varigraph_tpu_torch.io.fasta import read_fasta

    rng = np.random.default_rng(k)
    c1 = list(rng.choice(list("ACGT"), 9000))
    c1[100:160] = "N" * 60
    c1[1000] = "N"
    c1[4000:4400] = "A" * 400
    c1[5000:5300] = "acgt" * 75
    path = tmp_path / "ref.fa"
    path.write_text(">c1\n" + "".join(c1) + "\n>c2\nNNACGTACGTTTGACNNNN\n"
                    + ">c3\n" + "".join(rng.choice(list("ACGTN"), 700)) + "\n")
    fasta, _, size = read_fasta(str(path))
    ours = torch_build.make_genome_cbf(fasta, size, k, 5)
    theirs = jax_build.make_genome_cbf(fasta, size, k, 5)
    assert (ours.size, ours.num_hashes) == (theirs.size, theirs.num_hashes)
    np.testing.assert_array_equal(ours.filter.numpy(), np.asarray(theirs.filter))
    assert int(ours.filter.max()) > 1
