"""Read counting in the torch port (varigraph_tpu_torch/genotype/counting.py)
must leave table.cov bit for bit equal to the JAX package's count_reads on
the same FASTQ, whichever path the JAX side takes: its per-batch join, or
its large-table superbatch join (forced with _BANDED_MAX_KEYS = 0)."""

import gzip

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu.genotype.counting as jc  # noqa: E402
from varigraph_tpu.ops.sketch_ref import sketch_ref  # noqa: E402
from varigraph_tpu.ops.table import KmerTable as JaxTable  # noqa: E402
from varigraph_tpu_torch.genotype import counting as tc  # noqa: E402
from varigraph_tpu_torch.ops.table import KmerTable, count_join  # noqa: E402

K = 15
B, L = 32, 64


def _reads(nreads=150, seed=3):
    rng = np.random.default_rng(seed)
    reads = [
        "".join("ACGTN"[c] for c in rng.choice(
            5, size=int(rng.integers(30, 90)), p=[0.245] * 4 + [0.02]))
        for _ in range(nreads)
    ]
    reads += ["A" * 80, "ACGT" * 20, "AC"]   # repeats, palindromes, too short
    return reads


def _jax_table(reads):
    rng = np.random.default_rng(0)
    # table keys: every k-mer of half the reads, plus decoys
    kmers = np.concatenate([sketch_ref(r, K) for r in reads[::2]]).astype(np.uint64)
    decoys = (rng.integers(0, 1 << 50, size=64, dtype=np.uint64)
              << np.uint64(8)) | np.uint64(K)
    keys = np.unique(np.concatenate([kmers, decoys]))
    m = len(keys)
    return JaxTable.build(keys, np.ones(m, np.uint8), np.zeros((m, 1), np.uint8),
                          np.zeros(m, bool), 1)


def _torch_table(jt):
    return KmerTable.from_numpy(jt.keys_np(), None, jt.freq_np(),
                                jt.hap_words_np(), jt.refflag_np(), jt.nhap,
                                "cpu")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    reads = _reads()
    path = str(tmp_path_factory.mktemp("count") / "r.fq.gz")
    with gzip.open(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return path, reads


@pytest.mark.parametrize("jax_path", ["per_batch", "superbatch"])
def test_count_reads_matches_jax(fastq, monkeypatch, jax_path):
    path, reads = fastq
    jt = _jax_table(reads)
    if jax_path == "superbatch":
        monkeypatch.setattr(jc, "_BANDED_MAX_KEYS", 0)
        monkeypatch.setattr(jc, "_SUPER_ROWS", 4)
    want_bases = jc.count_reads(jt, [path], K, B, L, n_devices=1, io_threads=1)
    want = np.asarray(jt.cov)

    tt = _torch_table(jt)
    got_bases = tc.count_reads(tt, [path], K, B, L, io_threads=1)
    assert got_bases == want_bases
    assert tt.cov.dtype == torch.int32
    np.testing.assert_array_equal(tt.cov.numpy(), want.astype(np.int64))
    assert want.sum() > 0 and want.max() > 1


def test_plain_join_argument_gives_the_same_counts(fastq):
    """count_reads with the plain join passed explicitly (as chip_smoke.py
    recounts on the card) equals the default wrapper."""
    path, reads = fastq
    jt = _jax_table(reads)
    a, b = _torch_table(jt), _torch_table(jt)
    tc.count_reads(a, [path], K, B, L, io_threads=1)
    tc.count_reads(b, [path], K, B, L, io_threads=1, join=count_join)
    np.testing.assert_array_equal(a.cov.numpy(), b.cov.numpy())


def test_python_reader_gives_the_native_counts(fastq, monkeypatch):
    """Without the native reader (no C++ toolchain), the pure-Python feed
    must count exactly the same."""
    from varigraph_tpu_torch.io import fastq as feed

    path, reads = fastq
    jt = _jax_table(reads)
    native, python = _torch_table(jt), _torch_table(jt)
    tc.count_reads(native, [path], K, B, L, io_threads=1)
    monkeypatch.setattr(feed, "stream_packed_batches_native",
                        lambda *a, **kw: None)
    tc.count_reads(python, [path], K, B, L, io_threads=1)
    np.testing.assert_array_equal(python.cov.numpy(), native.cov.numpy())
    assert native.cov.sum() > 0


def test_counts_accumulate_over_files(fastq):
    """Two files count twice, in place, in any interleaving."""
    path, reads = fastq
    jt = _jax_table(reads)
    one, two = _torch_table(jt), _torch_table(jt)
    tc.count_reads(one, [path], K, B, L, io_threads=1)
    tc.count_reads(two, [path, path], K, B, L, io_threads=2)
    np.testing.assert_array_equal(two.cov.numpy(), 2 * one.cov.numpy())
