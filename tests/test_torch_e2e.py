"""End to end: ``python -m varigraph_tpu_torch genotype --device cpu`` against
``varigraph_tpu genotype`` on one data_gen dataset and one saved graph.  The
torch engine must give the JAX engine's records and GT; the host oracle
engine (copied) must give the JAX package's VCF byte for byte."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from varigraph_tpu.cli import main as jax_main  # noqa: E402
from varigraph_tpu.config import VarigraphConfig  # noqa: E402
from varigraph_tpu.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu.index.serialize import save_graph  # noqa: E402
from varigraph_tpu_torch.cli import main as torch_main  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_e2e"))
    paths, truth = generate_dataset(out, seed=11, chrom_lens={"chr1": 6000},
                                    n_variants=25, samples=("S1", "S2"),
                                    depth=30.0)
    gi = construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0))
    paths["graph"] = os.path.join(out, "graph.vgt")
    save_graph(gi, paths["graph"])
    return out, paths, truth


def _records(vcf):
    """[(chrom, pos, ref, alt, {FORMAT key: value})] of the data lines."""
    out = []
    with gzip.open(vcf, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            out.append((f[0], int(f[1]), f[3], f[4],
                        dict(zip(f[8].split(":"), f[9].split(":")))))
    return out


def _run(main, dataset, name, *extra):
    out, paths, _ = dataset
    out_dir = os.path.join(out, name)
    rc = main(["genotype", "--load-graph", paths["graph"], "-s", paths["cfg"],
               "--out-dir", out_dir, *extra])
    assert rc == 0
    return os.path.join(out_dir, "S1.varigraph.vcf.gz")


def test_torch_cli_matches_jax_cli(dataset):
    got = _records(_run(torch_main, dataset, "torch", "--device", "cpu"))
    want = _records(_run(jax_main, dataset, "jax"))
    assert [r[:4] for r in got] == [r[:4] for r in want] and want
    for g, w in zip(got, want):
        assert g[4]["GT"] == w[4]["GT"], g[:2]
        assert g[4]["NAK"] == w[4]["NAK"] and g[4]["UK"] == w[4]["UK"], g[:2]


def test_np_engine_vcf_is_byte_identical(dataset):
    got = _run(torch_main, dataset, "torch_np", "--device", "cpu",
               "--engine", "np")
    want = _run(jax_main, dataset, "jax_np", "--engine", "np")
    with gzip.open(got, "rt") as a, gzip.open(want, "rt") as b:
        assert a.read() == b.read()


def test_counts_checkpoint_round_trip_and_jax_format(dataset):
    """--save-counts writes the JAX package's npz format; --load-counts of it
    skips counting and gives the same VCF."""
    out, _, _ = dataset
    counts = os.path.join(out, "counts.npz")
    first = _run(torch_main, dataset, "save", "--device", "cpu",
                 "--save-counts", counts)
    z = np.load(counts)
    assert set(z.files) == {"cov", "keys", "read_base"}
    assert z["cov"].dtype == np.uint32 and z["keys"].dtype == np.uint64
    second = _run(torch_main, dataset, "load", "--device", "cpu",
                  "--load-counts", counts)
    with gzip.open(first, "rt") as a, gzip.open(second, "rt") as b:
        assert a.read() == b.read()
    jax_loaded = _run(jax_main, dataset, "jax_load", "--load-counts", counts)
    assert [r[:4] for r in _records(jax_loaded)] == \
        [r[:4] for r in _records(first)]


def test_genotypes_match_truth(dataset):
    out, _, truth = dataset
    called = {(c, p): sorted(int(g) for g in fmt["GT"].split("/"))
              for c, p, _, _, fmt in _records(
                  _run(torch_main, dataset, "truth", "--device", "cpu"))}
    agree = sum(called.get(site, [0, 0]) == sorted(gt)
                for site, gt in truth.items())
    assert agree >= 0.9 * len(truth)


@pytest.mark.parametrize("gq", ["20", "100", "1000"])
def test_min_support_masks_gt_as_jax_does(dataset, gq):
    """--min-support: calls below the GQ bar print GT '.', as in the JAX
    package (vcfout.py GQ masking).  This dataset's GQs are 99 and one
    159.5, so the bars mask none, all but one, and all of the calls."""
    got = _records(_run(torch_main, dataset, f"minsup{gq}", "--device", "cpu",
                        "--min-support", gq))
    want = _records(_run(jax_main, dataset, f"jax_minsup{gq}",
                         "--min-support", gq))
    assert [(r[:4], r[4]["GT"]) for r in got] == \
        [(r[:4], r[4]["GT"]) for r in want] and got
    masked = sum(set(r[4]["GT"]) <= set("./") for r in got)
    assert masked == {"20": 0, "100": len(got) - 1, "1000": len(got)}[gq]


def test_two_samples_match_single_sample_runs(dataset):
    """Two samples in one run (coverage reset between them) give each the
    VCF of a run of its own."""
    out, paths, _ = dataset
    with open(paths["cfg"]) as fh:
        fq = fh.read().split()[1]
    cfg2 = os.path.join(out, "two.cfg")
    with open(cfg2, "w") as fh:
        fh.write(f"A {fq}\nB {fq}\n")
    out_dir = os.path.join(out, "two")
    assert torch_main(["genotype", "--load-graph", paths["graph"], "-s", cfg2,
                       "--out-dir", out_dir, "--device", "cpu"]) == 0
    single = _run(torch_main, dataset, "single", "--device", "cpu")
    with gzip.open(single, "rt") as fh:
        want = fh.read()
    for name in ("A", "B"):
        with gzip.open(os.path.join(out_dir, f"{name}.varigraph.vcf.gz"),
                       "rt") as fh:
            assert fh.read() == want.replace("\tS1\n", f"\t{name}\n", 1)


def test_cuda_device_without_cuda_fails(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, paths, _ = dataset
    r = subprocess.run(
        [sys.executable, "-m", "varigraph_tpu_torch", "genotype",
         "--load-graph", paths["graph"], "-s", paths["cfg"],
         "--out-dir", os.path.join(out, "nocuda"), "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not os.path.exists(os.path.join(out, "nocuda"))
