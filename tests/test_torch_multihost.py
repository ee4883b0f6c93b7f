"""Multi-process genotyping in the torch port (varigraph_tpu_torch/parallel/
dist.py): a 2-process CPU run (torch.distributed on gloo) must write a VCF
byte-identical to the single-process run on the same files, for both engines
(the np oracle and the torch engine), and a rank that fails must make the
other fail instead of leaving it waiting.

Each process counts its round-robin share of the sample's FASTQ files, the
counts merge with one all-reduce, with the torch engine each process scores
its round-robin share of the windows and the results merge with one
all-gather, and rank 0 writes the VCF (the JAX package's tests/test_multihost.py, on the port's CLI)."""

import gzip
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu_torch.index.serialize import save_graph  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _split_fastq(src: str, outs: list[str]) -> None:
    fhs = [gzip.open(p, "wt") for p in outs]
    with gzip.open(src, "rt") as fh:
        rec, n = [], 0
        for line in fh:
            rec.append(line)
            if len(rec) == 4:
                fhs[n % len(fhs)].writelines(rec)
                rec, n = [], n + 1
    for fh in fhs:
        fh.close()


@pytest.fixture(scope="module")
def two_file_sample(tmp_path_factory):
    """A port-built graph and sample S1's reads split into two FASTQ files."""
    out = str(tmp_path_factory.mktemp("torch_multihost"))
    paths, _ = generate_dataset(
        out, seed=23, chrom_lens={"chr1": 5000}, n_variants=20,
        samples=("S1", "S2"), depth=25.0, target_sample="S1",
    )
    fqs = [os.path.join(out, f"S1_{i}.fq.gz") for i in range(2)]
    _split_fastq(paths["fq"], fqs)
    cfg_file = os.path.join(out, "samples2.cfg")
    with open(cfg_file, "w") as fh:
        fh.write("S1 " + " ".join(fqs) + "\n")
    gi = construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0,
        device="cpu"))
    gpath = os.path.join(out, "graph.vgt")
    save_graph(gi, gpath)
    return out, gpath, cfg_file


def _cli(argv: list[str]) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", "varigraph_tpu_torch", "genotype", *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _vcf(run_dir: str) -> bytes:
    with gzip.open(os.path.join(run_dir, "S1.varigraph.vcf.gz"), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("engine", ["np", "torch"])
def test_two_process_run_matches_single(two_file_sample, engine):
    out, gpath, cfg_file = two_file_sample
    base = ["--load-graph", gpath, "-s", cfg_file, "--engine", engine,
            "--device", "cpu", "--seed", "7", "-t", "1"]

    single_dir = os.path.join(out, f"single_{engine}")
    p = _cli(base + ["--out-dir", single_dir])
    _, err = p.communicate(timeout=TIMEOUT_S)
    assert p.returncode == 0, err[-2000:]

    port = _free_port()
    multi_dir = os.path.join(out, f"multi_{engine}")
    procs = [_cli(base + ["--out-dir", multi_dir, "--coordinator",
                          f"localhost:{port}", "--num-processes", "2",
                          "--process-id", str(i)]) for i in range(2)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT_S)
        errs.append(err)
        assert p.returncode == 0, err[-2000:]
    for e in errs:
        assert "merged counts from 2 hosts" in e
        # the torch engine splits the windows; the np oracle scores them all
        assert ("merged scoring results from 2 hosts" in e) == (engine == "torch")
    # each process counted one of the two files
    assert all(e.count("Processed ") == 1 for e in errs)

    single = _vcf(single_dir)
    assert single.count(b"\n") > 20
    assert _vcf(multi_dir) == single, "2-process VCF differs from 1-process VCF"


def test_failed_rank_fails_the_run(two_file_sample, tmp_path):
    """Rank 1 fails after joining the group (its graph file is missing);
    rank 0 must exit non-zero well inside the timeout, not wait on it."""
    out, gpath, cfg_file = two_file_sample
    port = _free_port()
    procs = [
        _cli(["--load-graph", g, "-s", cfg_file, "--device", "cpu", "-t", "1",
              "--out-dir", str(tmp_path), "--coordinator", f"localhost:{port}",
              "--num-processes", "2", "--process-id", str(i)])
        for i, g in enumerate([gpath, os.path.join(out, "missing.vgt")])
    ]
    rcs = []
    for p in procs:
        p.communicate(timeout=TIMEOUT_S)
        rcs.append(p.returncode)
    assert rcs[0] != 0 and rcs[1] != 0, rcs
    assert not os.path.exists(os.path.join(str(tmp_path), "S1.varigraph.vcf.gz"))
