"""Loading a .vgt in the torch port (varigraph_tpu_torch/index/serialize.py)
must give the same graph and table as the JAX package's load_graph: table
arrays, the precomputed node -> table CSR (tbl_csr), the k-mer CSR and the
metadata.  Also: the port never imports jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from varigraph_tpu.config import VarigraphConfig  # noqa: E402
from varigraph_tpu.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu.index.serialize import load_graph as jax_load  # noqa: E402
from varigraph_tpu.index.serialize import save_graph  # noqa: E402
from varigraph_tpu_torch.index.serialize import load_graph as torch_load  # noqa: E402
from varigraph_tpu_torch.ops.table import KmerTable  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "slice2m", "graph.vgt")


@pytest.fixture(scope="module")
def fresh_vgt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("load"))
    paths, _ = generate_dataset(out, seed=5, chrom_lens={"c1": 5000, "c2": 3000},
                                n_variants=15, samples=("S1", "S2", "S3"),
                                depth=2.0)
    gi = construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0))
    path = os.path.join(out, "graph.vgt")
    save_graph(gi, path)
    return path


def _assert_same(jg, tg):
    for attr in ("kmer_len", "vcf_ploidy", "graph_base_num", "genome_size",
                 "hap_names", "chrom_lens", "vcf_head", "vcf_info"):
        assert getattr(tg, attr) == getattr(jg, attr), attr
    assert vars(tg.stats) == vars(jg.stats)

    jt, tt = jg.table, tg.table
    assert tt.size == jt.size and tt.nhap == jt.nhap
    np.testing.assert_array_equal(tt.keys_np(), jt.keys_np())
    np.testing.assert_array_equal(tt.keys.numpy().view(np.uint64), jt.keys_np())
    np.testing.assert_array_equal(tt.freq_np(), jt.freq_np())
    np.testing.assert_array_equal(tt.hap_words_np(), jt.hap_words_np())
    np.testing.assert_array_equal(tt.refflag_np(), jt.refflag_np())
    np.testing.assert_array_equal(tt.cov_u8(), jt.cov_u8())
    assert tt.cov.dtype == torch.int32 and tt.keys.dtype == torch.int64

    jgr, tgr = jg.graph, tg.graph
    assert tgr.chroms == jgr.chroms
    for c in jgr.chroms:
        for csr in ("tbl_csr", "kmer_csr"):
            for a, b in zip(getattr(tgr, csr)[c], getattr(jgr, csr)[c]):
                np.testing.assert_array_equal(a, b)
        for dense in ("starts_np", "ends_np", "gt_mat", "gt_len"):
            np.testing.assert_array_equal(getattr(tgr, dense)[c],
                                          getattr(jgr, dense)[c])
        assert tgr.starts[c] == jgr.starts[c]
        assert [[str(s) for s in n.seqs] for n in tgr.nodes[c]] == \
            [[str(s) for s in n.seqs] for n in jgr.nodes[c]]


def test_load_committed_fixture_matches_jax():
    _assert_same(jax_load(FIXTURE), torch_load(FIXTURE, device="cpu"))


def test_load_fresh_graph_matches_jax(fresh_vgt):
    _assert_same(jax_load(fresh_vgt), torch_load(fresh_vgt, device="cpu"))


def test_from_numpy_carries_jax_table_state(fresh_vgt):
    jt = jax_load(fresh_vgt).table
    cov = np.arange(jt.size, dtype=np.uint32)
    tt = KmerTable.from_numpy(jt.keys_np(), cov, jt.freq_np(),
                              jt.hap_words_np(), jt.refflag_np(), jt.nhap,
                              "cpu")
    np.testing.assert_array_equal(tt.cov.numpy(), cov)
    np.testing.assert_array_equal(tt.cov_u8(), np.minimum(cov, 255))
    np.testing.assert_array_equal(tt.hapbit_rows_np(), jt.hapbit_rows_np())
    tt.reset_cov()
    assert int(tt.cov.sum()) == 0


def test_from_numpy_rejects_unsorted_keys():
    keys = np.array([5 << 8 | 27, 3 << 8 | 27], np.uint64)
    with pytest.raises(ValueError):
        KmerTable.from_numpy(keys, None, np.ones(2, np.uint8),
                             np.zeros((2, 1), np.uint32), np.zeros(2, bool),
                             3, "cpu")


def test_non_zip_graph_is_not_ported_yet(tmp_path):
    """A file that is not a zip is read as the reference binary's graph.bin
    (index/interop.py); a truncated one is an error, not a crash."""
    path = tmp_path / "graph.bin"
    path.write_bytes(b"\x01\x02not a zip")
    with pytest.raises(ValueError, match="nor a complete reference graph.bin"):
        torch_load(str(path))


def test_cli_import_leaves_jax_out():
    code = ("import sys, varigraph_tpu_torch.cli, "
            "varigraph_tpu_torch.genotype.pipeline, "
            "varigraph_tpu_torch.genotype.engine_torch, "
            "varigraph_tpu_torch.index.build, varigraph_tpu_torch.ops.cbf, "
            "varigraph_tpu_torch.ops.cbf_cuda, "
            "varigraph_tpu_torch.ops.exact_count, "
            "varigraph_tpu_torch.index.interop, "
            "varigraph_tpu_torch.parallel.dist, "
            "varigraph_tpu_torch.parallel.mesh; "
            "sys.exit('jax' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
