"""Construct's genome and context sketches in the torch port
(varigraph_tpu_torch/ops/{sketch,sketch_cuda}.py) against the JAX package's.

The exact genome count (``count_codes_``, the plain ``count_codes_plain``
behind ``ExactGenomeCounter``) must equal the JAX ``ExactGenomeCounter``
(``_count_codes_stack``) bit for bit on N-bearing genomes: Ns at row edges
and in the bases two rows share, an (AT)n tract, a poly-A run whose k-mer
counts past 255 before the cap, keys with bit 63 set, at k = 5, 16, 27, 28.
The context sketch (``sketch_contexts``, the CSR that ``index/build``
reads) must equal the JAX ``_sketch_contexts`` bit for bit: lengths 0, < k,
k, 160 and thousands, N runs, (AT)n at even k.  The card's design is
emulated on the CPU: the context sketch's two routes (the short route's
bitonic sort and duplicate drop in a warp's tile, its slot layout at the
context's own offset and the compaction; the long route's torch dedup)
against per-context np.unique and the plain version, and count_codes'
staged span and batched lookup against the chromosome and np.searchsorted.
The CUDA kernels (csrc/sketch.cu) are held against the plain versions and
the emulation on the card by the ``cuda``-marked cases, the count also
across launches and on misaligned codes, the context kernel also on
contexts of 50,000 and 1,000,000 bases against ``sketch_ref``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.index.build as torch_build  # noqa: E402
from varigraph_tpu_torch.ops import sketch_cuda  # noqa: E402
from varigraph_tpu_torch.ops.cbf import GENOME_COLS, genome_rows  # noqa: E402
from varigraph_tpu_torch.ops.exact_count import ExactGenomeCounter  # noqa: E402
from varigraph_tpu_torch.ops.sketch import (  # noqa: E402
    bitmap_bits, count_codes_plain, dedup_contexts, encode_contexts,
    key_bitmap_plain, sketch_contexts_plain)
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
                             sketch_cuda.key_bitmap(keys, bitmap_bits(keys.numel())),
                             torch.from_numpy(codes), k)
    count_codes_plain(b, keys, torch.from_numpy(codes), k)
    assert dict(sketch_cuda.LAUNCHES) == before
    assert torch.equal(a, b) and int(a.sum()) > 0


def _count_args(bad: str):
    keys = _t(np.array([5 << 8 | 27, 9 << 8 | 27], np.uint64))
    cov = torch.zeros(2, dtype=torch.int32)
    directory = key_directory(keys, 1)
    bitmap = key_bitmap_plain(keys, bitmap_bits(keys.numel()))
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
    elif bad == "bitmap_dtype":
        bitmap = bitmap.to(torch.int64)
    elif bad == "bitmap_size":
        bitmap = torch.zeros(3, dtype=torch.int32)
    elif bad == "bitmap_empty":
        bitmap = bitmap[:0]
    elif bad == "k0":
        k = 0
    elif bad == "k29":
        k = 29
    return cov, keys, directory, bitmap, codes, k


@pytest.mark.parametrize("bad", ["codes_dtype", "codes_2d", "codes_strided",
                                 "cov_dtype", "cov_shape", "directory_size",
                                 "bitmap_dtype", "bitmap_size", "bitmap_empty",
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


# ---------------------------------- the card's design, emulated on the CPU

TILE = sketch_cuda.CONTEXT_TILE
ALL_ONES = np.uint64((1 << 64) - 1)


def _bitonic(v: np.ndarray) -> np.ndarray:
    """The short route's sort (csrc/sketch.cu context_short_kernel): the
    bitonic network over the next power of two, padded with ~0, one
    compare-exchange a (lane, q) pair, ascending where lo & size is 0."""
    n = len(v)
    p2 = 1
    while p2 < n:
        p2 <<= 1
    t = np.full(p2, ALL_ONES, np.uint64)
    t[:n] = v
    size = 2
    while size <= p2:
        stride = size >> 1
        while stride:
            q = np.arange(p2 >> 1)
            lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1))
            x, y = t[lo], t[lo + stride]
            swap = (x > y) == ((lo & size) == 0)
            t[lo], t[lo + stride] = np.where(swap, y, x), np.where(swap, x, y)
            stride >>= 1
        size <<= 1
    return t[:n]


def _emulate_card_contexts(ctxs: list[str], k: int):
    """sketch_contexts as the card computes it: each context's windows
    (sketch_ref), the short route's sort and adjacent-duplicate drop written
    at out[offsets[c]...] for a context of at most TILE windows, the long
    route's torch dedup and scatter for a longer one, then the scan of the
    unique counts and the compaction.  Returns (values, starts, the contexts
    on the long route)."""
    codes, offsets = encode_contexts(ctxs)
    out = np.full(max(1, len(codes)), 0xDEAD, np.uint64)   # slots never read
    counts = np.zeros(len(ctxs), np.int64)
    long_ids = []
    for c, ctx in enumerate(ctxs):
        raw = np.array(sketch_ref(ctx, k), np.uint64)
        assert len(raw) <= max(0, len(ctx) - k + 1)      # the slot range holds them
        if len(ctx) - k + 1 > TILE:
            long_ids.append(c)
            continue
        t = _bitonic(raw)
        keep = np.ones(len(t), bool)
        keep[1:] = t[1:] != t[:-1]
        u = t[keep]
        out[offsets[c]:offsets[c] + len(u)] = u
        counts[c] = len(u)
    if long_ids:
        raws = [np.array(sketch_ref(ctxs[c], k), np.uint64) for c in long_ids]
        lc = torch.tensor([len(r) for r in raws], dtype=torch.int64)
        lv, ls = dedup_contexts(_t(np.concatenate(raws)), lc)
        lv, ls = lv.numpy().view(np.uint64), ls.numpy()
        for j, c in enumerate(long_ids):
            u = lv[ls[j]:ls[j + 1]]
            out[offsets[c]:offsets[c] + len(u)] = u
            counts[c] = len(u)
    starts = np.zeros(len(ctxs) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    values = np.concatenate([out[offsets[c]:offsets[c] + counts[c]]
                             for c in range(len(ctxs))] + [np.empty(0, np.uint64)])
    return values, starts, long_ids


def _route_contexts(case: str, k: int) -> list[str]:
    rng = np.random.default_rng(300 + k)

    def rand(n, p_n=0.0):
        p = [(1 - p_n) / 4] * 4 + [p_n]
        return "".join(rng.choice(list("ACGTN"), size=int(n), p=p))

    full = TILE + k - 1          # the bases of a context that fills the tile
    if case == "tile":
        return [rand(full), rand(full + 1), rand(full - 1), rand(full, 0.02),
                rand(40), rand(full + 300, 0.01)]
    if case == "duplicates":
        return ["A" * (full + 50), "A" * 200, "AT" * 300, "AT" * 40,
                "ACGTTG" * 100, "CA" * (full // 2 + 1), "GATTACA" * 90]
    if case == "lengths":
        return [rand(n) for n in (0, 1, k - 2, k - 1, k, k + 1, 2 * k)] + [""]
    if case == "n_runs":
        return [rand(100) + "N" * (2 * k) + rand(60) + "N" + rand(k),
                "N" * 300, rand(k - 1) + "N" + rand(k - 1),
                rand(full - 100) + "N" * 40 + rand(60),
                rand(full + 200, 0.05), rand(80, 0.3)]
    raise ValueError(case)


ROUTE_CASES = ["tile", "duplicates", "lengths", "n_runs"]


@pytest.mark.parametrize("k", [27, 28])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_card_context_design_matches_plain(case, k):
    """The short route's sort and duplicate drop, its slot layout and the
    compaction, with the long route beside it, against per-context
    np.unique and sketch_contexts_plain."""
    ctxs = _route_contexts(case, k)
    values, starts, long_ids = _emulate_card_contexts(ctxs, k)
    for c, ctx in enumerate(ctxs):
        want = np.unique(np.array(sketch_ref(ctx, k), np.uint64))
        np.testing.assert_array_equal(values[starts[c]:starts[c + 1]], want)
    codes, offsets = encode_contexts(ctxs)
    pv, ps = sketch_contexts_plain(torch.from_numpy(codes), torch.from_numpy(offsets), k)
    np.testing.assert_array_equal(values, pv.numpy().view(np.uint64))
    np.testing.assert_array_equal(starts, ps.numpy())
    lens = np.diff(offsets)
    assert long_ids == [c for c in range(len(ctxs)) if lens[c] - k + 1 > TILE]
    if case in ("tile", "duplicates"):
        assert long_ids and len(long_ids) < len(ctxs)
    if k == 28 and case == "tile":
        assert (values >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitonic_network_sorts_unsigned(seed):
    """The short route's network at every size up to the tile, powers of two
    and one past them, with bit-63 values and repeats."""
    rng = np.random.default_rng(seed)
    for n in sorted({0, 1, 2, 3, 31, 32, 33, 64, 100, 127, 128, 129, 255, 256,
                     257, 300, TILE - 1, TILE, *rng.integers(0, TILE + 1, 8)}):
        v = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        v[::3] |= np.uint64(1 << 63)
        v[1::7] = v[0] if n else v[1::7]
        np.testing.assert_array_equal(_bitonic(v), np.sort(v))


def _stage(codes: np.ndarray, mis: int, first: int, rows: int, k: int) -> np.ndarray:
    """count_codes_kernel's copy of a CTA's span: codes placed mis bytes past
    a 16-byte boundary, 16-byte chunks whole where they lie inside [a, b),
    byte by byte at either end; bytes outside [a, b) stay unset (0xEE)."""
    frame = np.concatenate([np.full(mis, 0xEE, np.uint8), codes,
                            np.full(32, 0xEE, np.uint8)])
    step, n = GENOME_COLS - (k - 1), len(codes)
    a = first * step + mis
    b = min(n, (first + rows - 1) * step + GENOME_COLS) + mis
    a0 = a & ~15
    stage = np.full((b - a0 + 15) // 16 * 16, 0xEE, np.uint8)
    for q in range((b - a0 + 15) >> 4):
        x = a0 + 16 * q
        if x >= a and x + 16 <= b:
            stage[16 * q:16 * q + 16] = frame[x:x + 16]
        else:
            for j in range(16):
                if a <= x + j < b:
                    stage[16 * q + j] = frame[x + j]
    assert len(stage) <= (255 * GENOME_COLS + GENOME_COLS + 16)   # kStage
    return stage, a0


@pytest.mark.parametrize("k", KS)
def test_count_codes_stage_holds_each_row(k):
    """Each thread's row read from the staged span (at g + mis - a0) is the
    chromosome's bases [g, g + min(160, n - g)), for every misalignment of
    the codes, for a CTA of 256 rows, a short last CTA and a launch that
    starts mid-chromosome."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, 50_000).astype(np.uint8)
    n, step = len(codes), GENOME_COLS - (k - 1)
    rows = genome_rows(n, k)
    for mis in (0, 1, 7, 15):
        for first in (0, 256, rows - 37, rows - 1):
            count = min(256, rows - first)
            stage, a0 = _stage(codes, mis, first, count, k)
            for r in range(first, first + count):
                g = r * step
                ln = min(GENOME_COLS, n - g)
                s = g + mis - a0
                np.testing.assert_array_equal(stage[s:s + ln], codes[g:g + ln])


def _bitmap_np(keys: np.ndarray, bbits: int) -> np.ndarray:
    """The occupancy bitmap as uint32 words, from the sorted keys alone."""
    shift = max(0, int(keys[-1]).bit_length() - bbits) if len(keys) else 0
    words = np.zeros(1 << (bbits - 5), np.uint32)
    q = (keys >> np.uint64(shift)).astype(np.int64)
    np.bitwise_or.at(words, q >> 5, (np.uint32(1) << (q & 31).astype(np.uint32)))
    return words


def _count_batch(keys: np.ndarray, directory: np.ndarray, v: np.ndarray,
                 em: np.ndarray, bitmap: np.ndarray, bbits: int) -> np.ndarray:
    """count_batch's search on the host: the bitmap's test, the bucket's
    directory pair, the lower-bound steps taken together while any n > 1,
    then the compare of keys[i] and keys[i + 1]; the index hit per value or
    -1."""
    bshift = max(0, int(keys[-1]).bit_length() - bbits)
    q = v >> np.uint64(bshift)
    inside = q < np.uint64(1 << bbits)
    qi = np.where(inside, q, 0).astype(np.int64)
    em = em & inside & (((bitmap[qi >> 5] >> (qi & 31).astype(np.uint32)) & 1) == 1)
    bits = len(directory).bit_length() - 1
    shift = max(0, int(keys[-1]).bit_length() - bits)
    p = v >> np.uint64(shift)
    inside = em & (p < np.uint64(1 << bits))
    pi = np.where(inside, p, 0).astype(np.int64)
    lo = np.where(inside, directory[pi], 0).astype(np.int64)
    hi = np.where(inside, directory[pi + 1], 0).astype(np.int64)
    n = hi - lo
    while (n > 1).any():
        act = n > 1
        half = n >> 1
        probe = keys[np.where(act, lo + half, 0)]
        lo = np.where(act & (probe < v), lo + half, lo)
        n = np.where(act, n - half, n)
    hit = np.full(len(v), -1)
    some = n > 0
    x0 = keys[np.where(some, lo, 0)]
    nxt = np.minimum(lo + 1, len(keys) - 1)
    x1 = np.where(some & (lo + 1 < hi), keys[nxt], 0)
    hit = np.where(some & (x0 == v), lo, hit)
    hit = np.where(some & (x0 < v) & (lo + 1 < hi) & (x1 == v), lo + 1, hit)
    return hit


@pytest.mark.parametrize("k", KS)
def test_count_batch_search_finds_every_key(k):
    """The batched lookup against np.searchsorted at the table's own
    directory and at skewed ones, behind the occupancy bitmap at its own
    size, the smallest and the largest (its plain version against numpy):
    emitted keys, absent values, values past every key, masked slots."""
    rng = np.random.default_rng(500 + k)
    queries = _queries(_genome(k), k)
    keys_t = _t(queries)
    probe = np.concatenate([queries, rng.integers(0, 1 << 62, 3000, dtype=np.uint64),
                            queries[-5:] + np.uint64(1), np.full(3, ALL_ONES)])
    em = rng.random(len(probe)) < 0.9
    want = np.searchsorted(queries, probe)
    found = (want < len(queries)) & (queries[np.minimum(want, len(queries) - 1)] == probe)
    want = np.where(em & found, want, -1)
    bbits = bitmap_bits(len(queries))
    bitmap = key_bitmap_plain(keys_t, bbits).numpy().view(np.uint32)
    np.testing.assert_array_equal(bitmap, _bitmap_np(queries, bbits))
    # the bitmap rejects most absent values and never a key
    absent = ~found
    assert (_count_batch(queries, key_directory(keys_t, 1).numpy(), probe,
                         np.ones(len(probe), bool), bitmap, bbits) >= 0).sum() == found.sum()
    for bits in (directory_bits(len(queries)), *SKEWED_DIRECTORY_BITS):
        directory = key_directory(keys_t, bits).numpy()
        for bb in (bbits, 5, 27):
            bm = bitmap if bb == bbits else key_bitmap_plain(keys_t, bb).numpy().view(np.uint32)
            np.testing.assert_array_equal(
                _count_batch(queries, directory, probe, em, bm, bb), want)
    q = probe[absent] >> np.uint64(max(0, int(queries[-1]).bit_length() - bbits))
    qi = np.where(q < np.uint64(1 << bbits), q, 0).astype(np.int64)
    cleared = ((bitmap[qi >> 5] >> (qi & 31).astype(np.uint32)) & 1) == 0
    assert cleared.mean() > 0.5


def test_bitmap_wrapper_on_cpu_runs_plain_and_checks_bits():
    keys = _t(_queries(_genome(28), 28))
    before = dict(sketch_cuda.LAUNCHES)
    got = sketch_cuda.key_bitmap(keys, 20)
    assert dict(sketch_cuda.LAUNCHES) == before
    assert torch.equal(got, key_bitmap_plain(keys, 20)) and got.dtype == torch.int32
    assert bitmap_bits(1) == 5 and bitmap_bits(2_904_480) == 27 and bitmap_bits(1000) == 15
    for bad in (4, 63):
        with pytest.raises(ValueError):
            sketch_cuda.key_bitmap(keys, bad)


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
    bitmap = sketch_cuda.key_bitmap(keys, bitmap_bits(keys.numel()))
    for bits in (directory_bits(keys.numel()), *SKEWED_DIRECTORY_BITS):
        got = torch.zeros_like(want)
        before = sketch_cuda.LAUNCHES["count_codes"]
        for c in codes.values():
            sketch_cuda.count_codes_(got, keys, key_directory(keys, bits), bitmap,
                                     c, k)
        torch.cuda.synchronize()
        assert sketch_cuda.LAUNCHES["count_codes"] == before + len(codes)
        assert torch.equal(got, want), bits


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 27])
def test_cuda_count_codes_across_launches_and_misaligned(k, monkeypatch):
    """A chromosome cut into launches mid-CTA (STAGE_POSITIONS lowered so a
    launch takes 300 rows, then 1) and codes that start 1, 7 and 15 bytes
    past a 16-byte boundary count as plain does."""
    dev = _card()
    codes = torch.from_numpy(_genome(k)["c1"]).to(dev)
    keys = _t(_queries(_genome(k), k)).to(dev)
    directory = key_directory(keys, directory_bits(keys.numel()))
    bitmap = sketch_cuda.key_bitmap(keys, bitmap_bits(keys.numel()))
    want = torch.zeros(keys.numel(), dtype=torch.int32, device=dev)
    count_codes_plain(want, keys, codes, k)
    rows = genome_rows(codes.numel(), k)
    for per_launch in (300, 1):
        monkeypatch.setattr(sketch_cuda, "STAGE_POSITIONS",
                            per_launch * (GENOME_COLS - k + 1))
        got = torch.zeros_like(want)
        before = sketch_cuda.LAUNCHES["count_codes"]
        sketch_cuda.count_codes_(got, keys, directory, bitmap, codes, k)
        torch.cuda.synchronize()
        assert sketch_cuda.LAUNCHES["count_codes"] - before == -(-rows // per_launch)
        assert torch.equal(got, want), per_launch
    monkeypatch.undo()
    for mis in (1, 7, 15):
        buf = torch.zeros(codes.numel() + 16, dtype=torch.uint8, device=dev)
        buf[mis:mis + codes.numel()] = codes
        view = buf[mis:mis + codes.numel()]
        assert view.data_ptr() % 16 == mis % 16
        got = torch.zeros_like(want)
        sketch_cuda.count_codes_(got, keys, directory, bitmap, view, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mis


@pytest.mark.cuda
@pytest.mark.parametrize("k", [27, 28])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_cuda_context_routes_match_emulation(case, k):
    """The card's two routes against their CPU emulation and sketch_ref: the
    contexts past the tile, and only those, take the long route."""
    dev = _card()
    ctxs = _route_contexts(case, k)
    values, starts, long_ids = _emulate_card_contexts(ctxs, k)
    codes, offsets = (torch.from_numpy(a).to(dev) for a in encode_contexts(ctxs))
    sketch_cuda.LONG_ROUTE.clear()
    v, s = sketch_cuda.sketch_contexts(codes, offsets, k)
    torch.cuda.synchronize()
    assert sketch_cuda.LONG_ROUTE["contexts"] == len(long_ids)
    np.testing.assert_array_equal(v.cpu().numpy().view(np.uint64), values)
    np.testing.assert_array_equal(s.cpu().numpy(), starts)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_cuda_key_bitmap_matches_plain(k):
    """The bitmap kernel against plain at the table's own size, the
    smallest and the largest, on keys with bit 63 set and on one key."""
    dev = _card()
    keys = _t(_queries(_genome(k), k)).to(dev)
    for table in (keys, keys[-1:].contiguous(), keys[:1].contiguous()):
        for bb in (bitmap_bits(table.numel()), 5, 27):
            before = sketch_cuda.LAUNCHES["key_bitmap"]
            got = sketch_cuda.key_bitmap(table, bb)
            torch.cuda.synchronize()
            assert sketch_cuda.LAUNCHES["key_bitmap"] == before + 1
            assert torch.equal(got, key_bitmap_plain(table, bb)), (table.numel(), bb)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["offsets_not_from_0", "offsets_decrease",
                                 "offsets_past_codes"])
def test_cuda_context_kernel_rejects_bad_offsets(bad):
    """The short route's kernel checks the offsets: each fault raises."""
    dev = _card()
    codes, offsets, k = _context_args(bad)
    with pytest.raises(ValueError):
        sketch_cuda.sketch_contexts(codes.to(dev), offsets.to(dev), k)
    v, s = sketch_cuda.sketch_contexts(codes.to(dev), torch.zeros(1, dtype=torch.int64,
                                                                  device=dev), k)
    assert v.numel() == 0 and s.tolist() == [0]


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
