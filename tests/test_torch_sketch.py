"""Construct's genome and context sketches in the torch port
(varigraph_tpu_torch/ops/{sketch,sketch_cuda}.py) against the JAX package's.

The exact genome count (``count_codes_``, the plain ``count_codes_plain``
behind ``ExactGenomeCounter``) must equal the JAX ``ExactGenomeCounter``
(``_count_codes_stack``) bit for bit on N-bearing genomes: Ns at row edges
and in the bases two rows share, an (AT)n tract, a poly-A run whose k-mer
counts past 255 before the cap, keys with bit 63 set, at k = 5, 16, 27, 28.
The context sketch (``sketch_contexts``, the CSR that ``index/build``
reads) must equal the JAX ``_sketch_contexts`` bit for bit: lengths 0, < k,
k, 160 and thousands, N runs, (AT)n at even k.  The CUDA kernels
(csrc/sketch.cu) are held against the plain versions on the card by the
``cuda``-marked cases, the context kernel also on contexts of 50,000 and
1,000,000 bases against ``sketch_ref``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.index.build as torch_build  # noqa: E402
from varigraph_tpu_torch.ops import sketch_cuda  # noqa: E402
from varigraph_tpu_torch.ops.cbf import GENOME_COLS  # noqa: E402
from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter  # noqa: E402
from varigraph_tpu_torch.ops.sketch import (  # noqa: E402
    count_codes_plain, dedup_contexts, encode_contexts, sketch_contexts_plain)
from varigraph_tpu_torch.ops.sketch_ref import sketch_ref  # noqa: E402
from varigraph_tpu_torch.ops.table import directory_bits, key_directory  # noqa: E402

# The JAX side is imported inside the tests that use it: the machine with the
# card has no JAX, and runs the kernel cases of this file alone with
#   python -m pytest --noconftest -m cuda tests/test_torch_sketch.py

KS = (5, 16, 27, 28)
SKEWED_DIRECTORY_BITS = (1, 16)   # besides each table's own


def _genome(k: int) -> dict[str, np.ndarray]:
    """Two chromosomes of base codes (4 = N): single Ns and an N run longer
    than k; Ns at a row's first base, at its last base and in the k - 1
    bases two rows share; an (AT)n tract (palindromes at even k); a
    2,000-base poly-A run; a chromosome that ends in an N run."""
    rng = np.random.default_rng(k)
    step = GENOME_COLS - (k - 1)
    c1 = rng.integers(0, 4, 12_000).astype(np.uint8)
    c1[500] = 4
    c1[900:900 + 2 * k + 3] = 4
    c1[3 * step] = 4
    c1[4 * step + GENOME_COLS - 1] = 4
    c1[7 * step + (k - 1) // 2] = 4
    c1[8 * step:8 * step + 2] = 4
    c1[2000:2200] = np.tile([0, 3], 100)
    c1[3000:5000] = 0
    c2 = rng.integers(0, 4, 700).astype(np.uint8)
    c2[650:] = 4
    return {"c1": c1, "c2": c2}


def _text(codes: np.ndarray) -> str:
    return np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()


def _queries(genome: dict[str, np.ndarray], k: int) -> np.ndarray:
    """Every value the genome emits, absent values and, at every k, decoys
    with bit 63 set: sorted and unique."""
    rng = np.random.default_rng(1000 + k)
    emitted = [np.array(sketch_ref(_text(c), k), np.uint64) for c in genome.values()]
    decoys = (rng.integers(0, 1 << 50, 200, dtype=np.uint64) << np.uint64(8)
              | np.uint64(k))
    decoys[::2] |= np.uint64(1 << 63)
    return np.unique(np.concatenate([*emitted, decoys]))


def _contexts(k: int) -> list[str]:
    """Contexts of lengths 0, 1, k - 1, k, k + 1, 160, 3,000 and random ones
    with a few Ns; one with N runs (one longer than k) and single Ns, one of
    (AT)n around random bases, one poly-A, one in lower case."""
    rng = np.random.default_rng(100 + k)

    def rand(n, p_n=0.02):
        p = [(1 - p_n) / 4] * 4 + [p_n]
        return "".join(rng.choice(list("ACGTN"), size=int(n), p=p))

    lens = [0, 1, k - 1, k, k + 1, GENOME_COLS, 3000]
    ctxs = [rand(n, 0.0) for n in lens] + [rand(n) for n in rng.integers(k, 300, 20)]
    ctxs.append(rand(150, 0) + "N" * (2 * k + 1) + rand(90, 0) + "N" + rand(40, 0))
    ctxs.append("AT" * 60 + rand(50, 0) + "TA" * 40)
    ctxs.append("A" * 400)
    ctxs.append(rand(200).lower())
    return ctxs


def _jax_contexts(monkeypatch, ctxs, k):
    import varigraph_tpu.index.build as jax_build

    # small JAX batches: the same per-context output, smaller CPU compiles
    monkeypatch.setattr(jax_build, "_CTX_BATCH_AREA", 4096)
    return jax_build._sketch_contexts(ctxs, k)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)
                            if a.dtype == np.uint64 else np.ascontiguousarray(a))


# ------------------------------------------------------- the exact count

@pytest.mark.parametrize("k", KS)
def test_plain_exact_count_matches_jax(k, monkeypatch):
    from varigraph_tpu.ops.exact_count import ExactGenomeCounter as JaxExact

    # one genome batch per JAX dispatch: the same counts, a smaller compile
    monkeypatch.setattr(JaxExact, "ADD_STACK", 1)
    codes = _genome(k)
    genome = {c: _text(v) for c, v in codes.items()}
    queries = _queries(codes, k)
    assert (queries >= np.uint64(1 << 63)).any()
    n = sum(len(s) for s in genome.values()) - k + 1
    got = ExactGenomeCounter(genome, k).count(queries)
    want = JaxExact(genome, n=n, k=k).count(queries)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the poly-A k-mer counts past 255 before the cap
    cov = torch.zeros(len(queries), dtype=torch.int32)
    for c in codes.values():
        count_codes_plain(cov, _t(queries), torch.from_numpy(c), k)
    assert int(cov.max()) > 255
    np.testing.assert_array_equal(got, np.minimum(cov.numpy(), 255))


def test_count_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    k = 27
    codes = _genome(k)["c1"]
    keys = _t(_queries({"c1": codes}, k))
    a = torch.zeros(keys.numel(), dtype=torch.int32)
    b = torch.zeros_like(a)
    before = dict(sketch_cuda.LAUNCHES)
    sketch_cuda.count_codes_(a, keys, key_directory(keys, directory_bits(keys.numel())),
                             torch.from_numpy(codes), k)
    count_codes_plain(b, keys, torch.from_numpy(codes), k)
    assert dict(sketch_cuda.LAUNCHES) == before
    assert torch.equal(a, b) and int(a.sum()) > 0


def _count_args(bad: str):
    keys = _t(np.array([5 << 8 | 27, 9 << 8 | 27], np.uint64))
    cov = torch.zeros(2, dtype=torch.int32)
    directory = key_directory(keys, 1)
    codes = torch.zeros(300, dtype=torch.uint8)
    k = 27
    if bad == "codes_dtype":
        codes = codes.to(torch.int32)
    elif bad == "codes_2d":
        codes = codes.reshape(3, 100)
    elif bad == "codes_strided":
        codes = torch.zeros(600, dtype=torch.uint8)[::2]
    elif bad == "cov_dtype":
        cov = cov.to(torch.int64)
    elif bad == "cov_shape":
        cov = torch.zeros(3, dtype=torch.int32)
    elif bad == "directory_size":
        directory = torch.zeros(4, dtype=torch.int32)
    elif bad == "k0":
        k = 0
    elif bad == "k29":
        k = 29
    return cov, keys, directory, codes, k


@pytest.mark.parametrize("bad", ["codes_dtype", "codes_2d", "codes_strided",
                                 "cov_dtype", "cov_shape", "directory_size",
                                 "k0", "k29"])
def test_count_wrapper_rejects_bad_arguments(bad):
    with pytest.raises((TypeError, ValueError)):
        sketch_cuda.count_codes_(*_count_args(bad))


# ------------------------------------------------------- the context sketch

@pytest.mark.parametrize("k", [27, 28])
def test_plain_context_csr_matches_jax(k, monkeypatch):
    ctxs = _contexts(k)
    want = _jax_contexts(monkeypatch, ctxs, k)
    values, starts, _ = torch_build.context_csr(ctxs, k, "cpu")
    assert values.dtype == starts.dtype == torch.int64
    v, s = values.numpy().view(np.uint64), starts.numpy()
    np.testing.assert_array_equal(np.diff(s), [len(w) for w in want])
    np.testing.assert_array_equal(v, np.concatenate(want))
    for c, w in zip(ctxs, want):
        np.testing.assert_array_equal(w, np.unique(np.array(sketch_ref(c, k), np.uint64)))
    if k == 28:
        assert (v >= np.uint64(1 << 63)).any()
    got = torch_build._sketch_contexts(ctxs, k)
    assert len(got) == len(want) and all(g.dtype == np.uint64 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert torch_build._sketch_contexts([], k) == []


def test_encode_contexts_concatenates_without_padding():
    codes, offsets = encode_contexts(["ACGT", "", "nN", "u"])
    np.testing.assert_array_equal(codes, [0, 1, 2, 3, 4, 4, 3])
    np.testing.assert_array_equal(offsets, [0, 4, 4, 6, 7])
    codes, offsets = encode_contexts([])
    assert codes.size == 0 and offsets.tolist() == [0]


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_matches_per_context_unique(seed):
    """The torch dedup the card path uses: values written context after
    context, duplicates within and across contexts, empty contexts, values
    with bit 63 set."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, 300)
    counts[[0, 7, 299]] = 0
    pool = rng.integers(0, 1 << 62, 50, dtype=np.uint64)
    pool[::3] |= np.uint64(1 << 63)
    values = rng.choice(pool, int(counts.sum()))
    got_v, got_s = dedup_contexts(_t(values), torch.from_numpy(counts))
    ends = np.cumsum(counts)
    want = [np.unique(values[e - n:e]) for n, e in zip(counts, ends)]
    np.testing.assert_array_equal(np.diff(got_s.numpy()), [len(w) for w in want])
    np.testing.assert_array_equal(got_v.numpy().view(np.uint64), np.concatenate(want))
    empty_v, empty_s = dedup_contexts(torch.empty(0, dtype=torch.int64),
                                      torch.zeros(3, dtype=torch.int64))
    assert empty_v.numel() == 0 and empty_s.tolist() == [0, 0, 0, 0]


def test_context_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    codes, offsets = encode_contexts(_contexts(27))
    before = dict(sketch_cuda.LAUNCHES)
    a = sketch_cuda.sketch_contexts(torch.from_numpy(codes), torch.from_numpy(offsets), 27)
    b = sketch_contexts_plain(torch.from_numpy(codes), torch.from_numpy(offsets), 27)
    assert dict(sketch_cuda.LAUNCHES) == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _context_args(bad: str):
    codes = torch.zeros(100, dtype=torch.uint8)
    offsets = torch.tensor([0, 40, 100])
    k = 27
    if bad == "codes_dtype":
        codes = codes.to(torch.int32)
    elif bad == "codes_2d":
        codes = codes.reshape(10, 10)
    elif bad == "offsets_dtype":
        offsets = offsets.to(torch.int32)
    elif bad == "offsets_strided":
        offsets = torch.tensor([0, 0, 40, 0, 100, 0])[::2]
    elif bad == "offsets_empty":
        offsets = offsets[:0]
    elif bad == "offsets_not_from_0":
        offsets = torch.tensor([1, 40, 100])
    elif bad == "offsets_decrease":
        offsets = torch.tensor([0, 60, 40, 100])
    elif bad == "offsets_past_codes":
        offsets = torch.tensor([0, 40, 101])
    elif bad == "k29":
        k = 29
    return codes, offsets, k


@pytest.mark.parametrize("bad", ["codes_dtype", "codes_2d", "offsets_dtype",
                                 "offsets_strided", "offsets_empty",
                                 "offsets_not_from_0", "offsets_decrease",
                                 "offsets_past_codes", "k29"])
def test_context_wrapper_rejects_bad_arguments(bad):
    with pytest.raises((TypeError, ValueError)):
        sketch_cuda.sketch_contexts(*_context_args(bad))


# ----------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sketch kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_cuda_count_codes_matches_plain(k):
    """Kernel against plain at the table's own directory and at skewed
    ones, one launch a chromosome."""
    dev = _card()
    codes = {c: torch.from_numpy(v).to(dev) for c, v in _genome(k).items()}
    keys = _t(_queries(_genome(k), k)).to(dev)
    want = torch.zeros(keys.numel(), dtype=torch.int32, device=dev)
    for c in codes.values():
        count_codes_plain(want, keys, c, k)
    assert int(want.max()) > 255
    for bits in (directory_bits(keys.numel()), *SKEWED_DIRECTORY_BITS):
        got = torch.zeros_like(want)
        before = sketch_cuda.LAUNCHES["count_codes"]
        for c in codes.values():
            sketch_cuda.count_codes_(got, keys, key_directory(keys, bits), c, k)
        torch.cuda.synchronize()
        assert sketch_cuda.LAUNCHES["count_codes"] == before + len(codes)
        assert torch.equal(got, want), bits


def _csr_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_cuda_sketch_contexts_matches_plain(k):
    dev = _card()
    codes, offsets = (torch.from_numpy(a).to(dev) for a in encode_contexts(_contexts(k)))
    before = sketch_cuda.LAUNCHES["sketch_contexts"]
    got = sketch_cuda.sketch_contexts(codes, offsets, k)
    torch.cuda.synchronize()
    assert sketch_cuda.LAUNCHES["sketch_contexts"] == before + 1
    assert _csr_equal(got, sketch_contexts_plain(codes, offsets, k))
    # the same run twice gives the same bits
    assert _csr_equal(got, sketch_cuda.sketch_contexts(codes, offsets, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [27, 28])
def test_cuda_long_contexts_match_sketch_ref(k):
    """Contexts of 50,000 and 1,000,000 bases (N runs, (AT)n, poly-A) beside
    short ones, against the numpy reference: no padding to the longest."""
    dev = _card()
    rng = np.random.default_rng(k)
    ctxs = []
    for n in (50_000, 1_000_000):
        c = rng.integers(0, 4, n).astype(np.uint8)
        c[n // 3:n // 3 + 5000] = 4
        c[n // 2:n // 2 + 2000] = np.tile([0, 3], 1000)
        c[n // 4:n // 4 + 3000] = 0
        c[rng.integers(0, n, 50)] = 4
        ctxs.append(_text(c))
    ctxs.insert(1, "ACGT" * 10)
    codes, offsets = (torch.from_numpy(a).to(dev) for a in encode_contexts(ctxs))
    values, starts = sketch_cuda.sketch_contexts(codes, offsets, k)
    v, s = values.cpu().numpy().view(np.uint64), starts.cpu().numpy()
    for i, c in enumerate(ctxs):
        np.testing.assert_array_equal(
            v[s[i]:s[i + 1]], np.unique(np.array(sketch_ref(c, k), np.uint64)))
