"""The genotyping window prep's per-k-mer pass against the JAX package.

The plain versions in ``ops/prep.py`` (reached through the wrappers
``ops/prep_cuda.hap_mass_`` and ``gather_rows_`` on CPU tensors) are held to
the JAX package's own lines: the mass to ``varigraph_tpu.genotype.hapselect.
window_hap_counts``, the gather to the arrays of ``varigraph_tpu.genotype.
engine_jax._WindowPrep`` (its bits and local bits packed into words with the
JAX package's ``pack_hapbits``), bit for bit.  Cases: random CSR windows
over two chromosomes (the second's rows starting past 0), a node with no
row, a node whose rows meet no top haplotype, a node keeping 128 rows,
coverage past 255, 5, 65 and 332 haplotypes, used-hap counts past 32 (two
words), pad rows.  The engine's prep (``_WindowPrep``, ``_gather_group``) on
the committed 2 Mb graph is held to the JAX engine's windows, with and
without the ``sv_genotype_only`` filter; the route's counters.

The card has no JAX, so the JAX engine's results on the committed graph are
kept in ``tests/fixtures/slice2m/jax_prep.json`` (each window's mass, top and
used haplotypes and a digest of its gathered arrays, and every site's
record), which a CPU test holds to a fresh run of the JAX package.
``test_genotype_torch_matches_jax`` holds the engine to that file on the CPU
and, marked ``cuda``, with the table and the scoring on the card.  Rewrite
the file after a change to the graph with, from the repository's root,

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_prep.py

On the card (marked ``cuda``; skipped without one) besides: each kernel
against its plain version on every case, run to run bit for bit, one launch
a call; the engine's card route (its gathered rows equal to the CPU route's,
its counters and launches; several groups, each prepped while the one
before is scored, give one group's calls).  Run there with

    python -m pytest --noconftest -m cuda tests/test_torch_prep.py
"""

from __future__ import annotations

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import (make_windows,  # noqa: E402
                                                    window_rng_seed)
from varigraph_tpu_torch.ops import prep_cuda  # noqa: E402
from varigraph_tpu_torch.ops.prep import PrepTables  # noqa: E402
from varigraph_tpu_torch.ops.table import KmerTable, pack_hapbits  # noqa: E402
from varigraph_tpu_torch.utils import timing  # noqa: E402

K = 128
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "slice2m",
                       "graph.vgt")
# the JAX engine's results on the committed graph, for the card
REFERENCE = os.path.join(os.path.dirname(FIXTURE), "jax_prep.json")
# the reference's run: coverage drawn from COV_SEED, below COV_MAX
COV_SEED, COV_MAX = 11, 40
REF_CFG = dict(granularity_bp=500_000, seed=0)
HAP_COV = 10.0
# the whole engine against the JAX one: tests/test_torch_engine.py's GPP
# tolerance (float32 sums in another order); GT, UK and NAK exact.  The
# reference file against a fresh JAX run: the same integers, and GPP within
# a few float32 ulp, as another XLA build may sum in another order.
GPP_TOL = 2e-3
REF_GPP_TOL = 1e-6


def _jax():
    """The JAX package's engine module (tier-1 tests run on the CPU with
    JAX; the card has none)."""
    return pytest.importorskip("varigraph_tpu.genotype.engine_jax")


def fixture_cov(size: int) -> np.ndarray:
    return np.random.default_rng(COV_SEED).integers(0, COV_MAX, size).astype(
        np.int32)


def rows_digest(c, f, flag, kmask, bits, local, kind) -> str:
    """sha256 of one window's gathered arrays: c, f, flag, kmask as uint8
    [n, K], the bits and local words as uint32 [n, K, ceil(U / 32)], kind
    int32 [n]."""
    h = hashlib.sha256()
    for a, dt in ((c, np.uint8), (f, np.uint8), (flag, np.uint8),
                  (kmask, np.uint8), (bits, np.uint32), (local, np.uint32),
                  (kind, np.int32)):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dt)).tobytes())
    return h.hexdigest()


def jax_window_arrays(prep):
    """A JAX ``_WindowPrep``'s gathered arrays, its bits packed with the JAX
    package's ``pack_hapbits``: (c, f, flag, kmask, bits, local, kind)."""
    from varigraph_tpu.ops.table import pack_hapbits as jax_pack

    n, _, U = prep.bits_u.shape

    def pack(a):
        return jax_pack(a.reshape(n * K, U)).reshape(n, K, -1)

    return (prep.c, prep.f, prep.flag, prep.kmask, pack(prep.bits_u),
            pack(prep.local_u), prep.kind)


class _MassSpy:
    """Records each k-mer mass a module's ``dirichlet_top_haps`` is given,
    and passes it on (or, with ``top``, returns those haplotypes)."""

    def __init__(self, module, top=None):
        self.module, self.real, self.top = module, module.dirichlet_top_haps, top
        self.masses = []

    def __call__(self, counts, haploid_num, rng):
        self.masses.append(np.asarray(counts).copy())
        if self.top is None:
            return self.real(counts, haploid_num, rng)
        return ([int(h) for h in self.top],
                {int(h): 1.0 / len(self.top) for h in self.top})

    def __enter__(self):
        self.module.dirichlet_top_haps = self
        return self

    def __exit__(self, *exc):
        self.module.dirichlet_top_haps = self.real


def jax_reference() -> dict:
    """The JAX engine's prep and records on the committed graph, coverage
    drawn from COV_SEED: for each window its mass, top and used haplotypes,
    node count and ``rows_digest``; for each site its GT (the sorted allele
    of each called haplotype), UK, NAK and GPP."""
    ej = _jax()
    from varigraph_tpu.config import VarigraphConfig as JaxConfig
    from varigraph_tpu.genotype.engine_np import graph2node
    from varigraph_tpu.genotype.engine_np import make_windows as jax_windows
    from varigraph_tpu.genotype.engine_np import window_rng_seed as jax_seed
    from varigraph_tpu.index.serialize import load_graph

    jgi = load_graph(FIXTURE)
    graph2node(jgi)
    cov_u8 = np.minimum(fixture_cov(jgi.table.size), 255).astype(np.uint8)
    arrays = (cov_u8, jgi.table.freq_np(), jgi.table.hap_words_np(),
              jgi.table.refflag_np())
    cfg = JaxConfig(**REF_CFG)
    windows = []
    for chrom in sorted(jgi.graph.nodes):
        starts = jgi.graph.starts[chrom]
        for w_id, (lo, hi) in enumerate(jax_windows(starts, jgi.chrom_lens[chrom],
                                                    cfg.granularity_bp)):
            rng = np.random.Generator(np.random.PCG64([cfg.seed, jax_seed(chrom),
                                                       w_id]))
            with _MassSpy(ej) as spy:
                prep = ej._WindowPrep(jgi, cfg, chrom, lo, hi, rng, *arrays,
                                      HAP_COV)
            if not prep.node_refs:
                continue
            windows.append(dict(
                chrom=chrom, w_id=w_id, mass=[int(x) for x in spy.masses[0]],
                top_hap=[int(h) for h in prep.top_hap],
                used_haps=[int(h) for h in prep.used_haps],
                nodes=len(prep.node_refs),
                rows_sha256=rows_digest(*jax_window_arrays(prep))))
    res = ej.genotype_jax(jgi, cfg, HAP_COV, cfg.seed, arrays)
    return dict(cov_seed=COV_SEED, cov_max=COV_MAX, hap_cov=HAP_COV, **REF_CFG,
                windows=windows, records=site_records(jgi, res))


def site_records(gi, res) -> dict:
    """{"chrom:start": [GT, UK, NAK, GPP]} of an engine's records."""
    node_at = {(c, n.start): n for c in gi.graph.nodes for n in gi.graph.nodes[c]}
    return {f"{c}:{s}": [sorted(int(node_at[c, s].hap_gt[h]) for h in r.hap_vec),
                         int(r.uk), [int(x) for x in r.kmer_num_vec],
                         float(r.probability)]
            for (c, s), r in sorted(res.items())}


# ---------------------------------------------------------------- the cases

CASES = {
    "h65": dict(nhap=65, n_used=20),
    "h65_two_words": dict(nhap=65, n_used=40),
    "h332": dict(nhap=332, n_used=60),
    "h5": dict(nhap=5, n_used=5),
}


def make_case(seed, nhap, n_used, M=2500, nodes=(50, 40), G=3):
    """A k-mer table and a CSR over two chromosomes, as KmerTable and
    ``graph.tbl_csr`` hold them, and G windows: (table, tbl_csr, windows),
    each window (chrom, node ids, top haps, used haps).  Entries 0-49 carry
    no haplotype, 50-99 every one; node 0 of each chromosome has no row,
    node 1 128 rows of entries 50-99, node 2 40 rows of entries 0-49."""
    rng = np.random.default_rng(seed)
    bits = (rng.random((M, nhap)) < 0.3).astype(np.uint8)
    bits[:50] = 0
    bits[50:100] = 1
    words = pack_hapbits(bits)
    keys = np.arange(1, M + 1, dtype=np.uint64) * np.uint64(7919)
    cov = rng.integers(0, 300, M).astype(np.int32)
    freq = rng.choice([0, 1, 1, 1, 2, 5], M).astype(np.uint8)
    refflag = rng.random(M) < 0.3
    table = KmerTable.from_numpy(keys, cov, freq, words, refflag, nhap, "cpu")
    nb = (nhap + 7) // 8
    tbl_csr = {}
    for ci, n in enumerate(nodes):
        lens = rng.integers(0, 70, n)
        lens[0], lens[1], lens[2] = 0, K, 40
        lead = 5 * ci                       # the second's rows start past 0
        off = np.zeros(n + 1, np.int64)
        off[1:] = np.cumsum(lens)
        off += lead
        idx = rng.integers(0, M, int(off[-1])).astype(np.int64)
        idx[off[1]:off[2]] = rng.integers(50, 100, K)
        idx[off[2]:off[3]] = rng.integers(0, 50, 40)
        lp = rng.integers(0, 256, (int(off[-1]), nb)).astype(np.uint8)
        tbl_csr[f"c{ci}"] = (off, idx, lp)
    windows = []
    for g in range(G):
        chrom = f"c{g % len(nodes)}"
        n = nodes[g % len(nodes)]
        cand = np.sort(rng.choice(n, size=n - 3 * g, replace=False)).astype(np.int64)
        cand = np.union1d(cand, [0, 1, 2]).astype(np.int64)
        top = np.sort(rng.choice(nhap, size=min(15, nhap), replace=False))
        used = np.sort(rng.choice(nhap, size=n_used, replace=False))
        windows.append((chrom, cand, top, used))
    return table, tbl_csr, windows


def _group_inputs(tables, windows, device="cpu"):
    """nodes, top and used of a group, as ``_gather_group`` builds them."""
    G = len(windows)
    N = max(len(w[1]) for w in windows)
    U = 32 * -(-max(len(w[3]) for w in windows) // 32)
    Wt = tables.hapbits.shape[1]
    nodes = np.full((G, N), -1, np.int64)
    top = np.zeros((G, Wt), np.uint32)
    used = np.full((G, U), -1, np.int32)
    for g, (chrom, cand, th, uh) in enumerate(windows):
        nodes[g, :len(cand)] = cand + tables.base[chrom]
        for h in th:
            top[g, h >> 5] |= np.uint32(1 << (h & 31))
        used[g, :len(uh)] = uh
    return tuple(torch.from_numpy(a).to(device)
                 for a in (nodes, top.view(np.int32), used))


def _outputs(G, N, U, device="cpu"):
    return (*(torch.full((G, N, K), 7, dtype=dt, device=device)
              for dt in (torch.uint8, torch.uint8)),
            *(torch.ones((G, N, K), dtype=torch.bool, device=device)
              for _ in range(2)),
            *(torch.full((G, N, K, U // 32), -1, dtype=torch.int32, device=device)
              for _ in range(2)),
            torch.full((G, N), 9, dtype=torch.int32, device=device))


def run_gather(tables, cov, windows, device="cpu"):
    nodes, top, used = _group_inputs(tables, windows, device)
    G, N = nodes.shape
    out = _outputs(G, N, used.shape[1], device)
    prep_cuda.gather_rows_(*out, nodes, top, used, tables, cov)
    return tuple(t.cpu().numpy() for t in out)


def run_mass(tables, cov, windows, device="cpu"):
    nodes = _group_inputs(tables, windows, device)[0]
    out = torch.full((nodes.shape[0], tables.nhap), -1, dtype=torch.int64,
                     device=device)
    prep_cuda.hap_mass_(out, nodes, tables, cov)
    return out.cpu().numpy()


def jax_window(table, tbl_csr, chrom, cand, top, used):
    """The JAX engine's ``_WindowPrep`` over one synthetic window: node
    ``cand`` the window's variant nodes, ``top`` its top haplotypes and
    ``used`` its used ones (in place of the Dirichlet draw and the states):
    (the prep, the k-mer mass its selection was given)."""
    ej = _jax()
    from varigraph_tpu.config import VarigraphConfig as JaxConfig

    n = len(tbl_csr[chrom][0]) - 1
    gt_len = np.ones(n, np.int32)
    gt_len[cand] = 2
    starts = 100 * np.arange(n, dtype=np.int64)
    graph = SimpleNamespace(
        nodes={chrom: [SimpleNamespace(start=int(x)) for x in starts]},
        gt_len={chrom: gt_len}, tbl_csr=tbl_csr, starts_np={chrom: starts},
        ends_np={chrom: starts + 50},
        gt_submatrix=lambda c, nodes, haps: np.zeros((len(nodes), len(haps)),
                                                     np.int32))
    gi = SimpleNamespace(nhap=table.nhap, graph=graph, vcf_info={})
    states = ej.increment_vector
    ej.increment_vector = lambda *a: [[int(h)] for h in used]
    try:
        with _MassSpy(ej, top) as spy:
            prep = ej._WindowPrep(gi, JaxConfig(), chrom, 0, n, None,
                                  table.cov_u8(), table.freq, table.hapbits,
                                  table.refflag, HAP_COV)
    finally:
        ej.increment_vector = states
    assert prep.top_hap == [int(h) for h in top]
    assert prep.used_haps == [int(h) for h in used]
    return prep, spy.masses[0]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_mass_matches_jax(name):
    """Each window's mass equals the JAX package's ``window_hap_counts``
    over the window's rows, and the mass the JAX engine's selection gets."""
    from varigraph_tpu.genotype.hapselect import window_hap_counts

    ej = _jax()
    table, tbl_csr, windows = make_case(3, **CASES[name])
    tables = PrepTables.upload(table, tbl_csr)
    got = run_mass(tables, table.cov, windows)
    for g, (chrom, cand, top, used) in enumerate(windows):
        off, idx, _ = tbl_csr[chrom]
        want = window_hap_counts([idx[ej._csr_flat(off, cand)]], table.cov_u8(),
                                 table.freq, table.hapbits, table.nhap)
        assert want.any()
        np.testing.assert_array_equal(got[g], want.astype(np.int64))
        _, seen = jax_window(table, tbl_csr, chrom, cand, top, used)
        np.testing.assert_array_equal(got[g], seen.astype(np.int64))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_gather_matches_jax(name):
    """The group's gathered rows, window by window, equal the arrays of the
    JAX engine's ``_WindowPrep`` for the same top and used haplotypes."""
    table, tbl_csr, windows = make_case(5, **CASES[name])
    tables = PrepTables.upload(table, tbl_csr)
    c, f, flag, kmask, bits, local, kind = run_gather(tables, table.cov, windows)
    for g, (chrom, cand, top, used) in enumerate(windows):
        prep, _ = jax_window(table, tbl_csr, chrom, cand, top, used)
        wc, wf, wflag, wk, wb, wl, wkind = jax_window_arrays(prep)
        n = len(cand)
        for got, want in ((c, wc), (f, wf), (flag, wflag), (kmask, wk)):
            np.testing.assert_array_equal(got[g, :n], want)
            assert not got[g, n:].any()
        for got, want in ((bits, wb), (local, wl)):
            packed = got[g, :n, :, :want.shape[2]].view(np.uint32)
            np.testing.assert_array_equal(packed, want)
            assert not got[g, :n, :, want.shape[2]:].any() and not got[g, n:].any()
        np.testing.assert_array_equal(kind[g, :n], wkind)
        assert not kind[g, n:].any()
        # the edge nodes: no row, 128 kept rows, rows that meet no top hap
        assert kind[g, 0] == 2 and kind[g, 2] == 2 and not kmask[g, 2].any()
        assert kind[g, 1] == 1 and kmask[g, 1].all()
    assert (c == 255).any() and kmask.any()
    assert bits.shape[3] == -(-CASES[name]["n_used"] // 32)


def test_the_tables_hold_every_chromosome_in_one_csr():
    table, tbl_csr, _ = make_case(9, 65, 20)
    t = PrepTables.upload(table, tbl_csr)
    off, idx, lp = t.off.numpy(), t.idx.numpy(), t.lp.numpy()
    for chrom, (o, i, b) in tbl_csr.items():
        base = t.base[chrom]
        for v in range(len(o) - 1):
            rows = slice(off[base + v], off[base + v + 1])
            np.testing.assert_array_equal(idx[rows], i[o[v]:o[v + 1]])
            np.testing.assert_array_equal(lp[rows], b[o[v]:o[v + 1]])
    assert off[-1] == len(idx) and t.idx.dtype == torch.int32
    assert t.nbytes() == (table.size * (2 + 4 * table.hapbits.shape[1])
                          + 8 * len(off) + len(idx) * (4 + lp.shape[1]))
    # on the CPU the table's own arrays, not copies
    assert np.shares_memory(t.freq.numpy(), table.freq)
    assert np.shares_memory(t.hapbits.numpy(), table.hapbits)


# ---------------------------------------------- the engine on the 2 Mb graph

@pytest.fixture(scope="module")
def fixture_gi():
    from varigraph_tpu_torch.genotype.engine_np import graph2node
    from varigraph_tpu_torch.index.serialize import load_graph

    gi = load_graph(FIXTURE, device="cpu")
    graph2node(gi)
    gi.table.cov.copy_(torch.from_numpy(fixture_cov(gi.table.size)))
    return gi


@pytest.fixture(scope="module")
def jax_gi():
    _jax()
    from varigraph_tpu.genotype.engine_np import graph2node
    from varigraph_tpu.index.serialize import load_graph

    jgi = load_graph(FIXTURE)
    graph2node(jgi)
    return jgi


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as fh:
        return json.load(fh)


def _windows(gi, cfg):
    for chrom in sorted(gi.graph.nodes):
        starts = gi.graph.starts[chrom]
        for w_id, (lo, hi) in enumerate(make_windows(starts, gi.chrom_lens[chrom],
                                                     cfg.granularity_bp)):
            yield chrom, w_id, lo, hi


def _preps(gi, cfg, tables):
    """The engine's ``_WindowPrep`` of every window with a scored node, and
    the mass each window's selection was given."""
    out = []
    with _MassSpy(et) as spy:
        for chrom, w_id, lo, hi in _windows(gi, cfg):
            rng = np.random.Generator(np.random.PCG64([cfg.seed,
                                                       window_rng_seed(chrom), w_id]))
            prep = et._WindowPrep(gi, cfg, chrom, lo, hi, rng, HAP_COV, tables)
            if prep.node_refs:
                out.append((prep, spy.masses[-1]))
    return out


def _sv_gi(gi):
    """The graph with a third of its sites' ALT alleles made 60 bases long,
    so that ``sv_genotype_only`` keeps those."""
    import copy

    sv = copy.copy(gi)
    rng = np.random.default_rng(2)
    sv.vcf_info = {c: {p: (list(v[:4]) + ["A" * 60] + list(v[5:])
                           if rng.random() < 1 / 3 else v)
                       for p, v in info.items()}
                   for c, info in gi.vcf_info.items()}
    return sv


@pytest.mark.parametrize("sv", [False, True])
def test_the_engines_prep_matches_jax(fixture_gi, jax_gi, sv):
    """``_WindowPrep`` and ``_gather_group`` on the CPU (the wrappers'
    plain versions) give the JAX engine's mass, selection, scored nodes and
    gathered arrays, window by window."""
    ej = _jax()
    from varigraph_tpu.config import VarigraphConfig as JaxConfig

    gi = _sv_gi(fixture_gi) if sv else fixture_gi
    jgi = _sv_gi(jax_gi) if sv else jax_gi
    cfg = VarigraphConfig(device="cpu", granularity_bp=300_000,
                          sv_genotype_only=sv, seed=3)
    jcfg = JaxConfig(granularity_bp=300_000, sv_genotype_only=sv, seed=3)
    arrays = (fixture_gi.table.cov_u8(), jgi.table.freq_np(),
              jgi.table.hap_words_np(), jgi.table.refflag_np())
    tables = PrepTables.upload(gi.table, gi.graph.tbl_csr)
    before = timing.counters()
    got = _preps(gi, cfg, tables)
    moved = timing.counters_since(before)
    want = []
    with _MassSpy(ej) as spy:
        for chrom, w_id, lo, hi in _windows(gi, cfg):
            rng = np.random.Generator(np.random.PCG64([jcfg.seed,
                                                       window_rng_seed(chrom), w_id]))
            prep = ej._WindowPrep(jgi, jcfg, chrom, lo, hi, rng, *arrays, HAP_COV)
            if prep.node_refs:
                want.append((prep, spy.masses[-1]))
    assert len(got) == len(want) > 1
    assert moved.get("prep.plain_windows") >= len(got)
    assert "prep.card_windows" not in moved
    for (pa, ma), (pb, mb) in zip(got, want):
        np.testing.assert_array_equal(ma, mb)
        assert pa.top_hap == pb.top_hap and pa.states == pb.states
        assert pa.used_haps == pb.used_haps
        np.testing.assert_array_equal(pa.node_idx, pb.node_idx)
    if sv:
        assert sum(len(p.node_idx) for p, _ in got) < sum(
            int((fixture_gi.graph.gt_len[p.chrom] > 1).sum()) for p, _ in got)
    rows = [a.numpy() for a in et._gather_group([p for p, _ in got], tables,
                                                gi.table.cov)]
    assert rows[0].dtype == np.uint8 and rows[4].dtype == np.int32
    for g, (pb, _) in enumerate(want):
        n = len(pb.node_refs)
        for a, b in zip(rows, jax_window_arrays(pb)):
            part = a[g, :n]
            if a.ndim == 4:
                assert not part[..., b.shape[2]:].any()
                part = part[..., :b.shape[2]].view(np.uint32)
            np.testing.assert_array_equal(part, b)
            assert not a[g, n:].any()
    assert (rows[6] == 1).any() and rows[3].any()


def test_the_jax_reference_file_is_the_jax_packages(reference):
    """The committed reference equals a fresh run of the JAX package."""
    fresh = jax_reference()
    assert {k: v for k, v in fresh.items() if k != "records"} == {
        k: v for k, v in reference.items() if k != "records"}
    assert fresh["records"].keys() == reference["records"].keys()
    for k, (gt, uk, nak, gpp) in fresh["records"].items():
        assert reference["records"][k][:3] == [gt, uk, nak], k
        assert abs(reference["records"][k][3] - gpp) <= REF_GPP_TOL, k
    assert len(fresh["windows"]) > 1 and len(fresh["records"]) > 1000


def _engine_on(device: str, fixture_gi):
    from varigraph_tpu_torch.genotype.engine_np import graph2node
    from varigraph_tpu_torch.index.serialize import load_graph

    if device == "cpu":
        return fixture_gi
    gi = load_graph(FIXTURE, device=device)
    graph2node(gi)
    gi.table.cov.copy_(fixture_gi.table.cov.to(device))
    return gi


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_genotype_torch_matches_jax(fixture_gi, reference, device):
    """The engine, its table and scoring on ``device``, against the JAX
    engine's results in the reference file: each window's mass, selection
    and gathered arrays (by digest) exactly, and at every site the same GT,
    UK and NAK, GPP within GPP_TOL."""
    if device == "cuda":
        _need_card()
    gi = _engine_on(device, fixture_gi)
    cfg = VarigraphConfig(device=device, **REF_CFG)
    before = timing.counters()
    res = et.genotype_torch(gi, cfg, HAP_COV, cfg.seed)
    moved = timing.counters_since(before)
    route = "prep.card_windows" if device == "cuda" else "prep.plain_windows"
    assert moved[route] == len(list(_windows(gi, cfg)))
    got = site_records(gi, res)
    want = reference["records"]
    assert got.keys() == want.keys() and want
    for k, (gt, uk, nak, gpp) in want.items():
        assert got[k][:3] == [gt, uk, nak], k
        assert abs(got[k][3] - gpp) <= GPP_TOL, k

    tables = gi.prep_tables
    assert tables is not None and tables.device.type == device
    preps = _preps(gi, cfg, tables)
    assert len(preps) == len(reference["windows"])
    rows = [a.cpu().numpy() for a in et._gather_group([p for p, _ in preps],
                                                      tables, gi.table.cov)]
    for g, ((prep, mass), w) in enumerate(zip(preps, reference["windows"])):
        assert (prep.chrom, len(prep.node_refs)) == (w["chrom"], w["nodes"])
        assert [int(x) for x in mass] == w["mass"]
        assert prep.top_hap == w["top_hap"] and prep.used_haps == w["used_haps"]
        n, ww = w["nodes"], -(-len(w["used_haps"]) // 32)
        win = [a[g, :n] if a.ndim < 4 else a[g, :n, :, :ww].view(np.uint32)
               for a in rows]
        assert rows_digest(*win) == w["rows_sha256"], g


def test_the_cpu_route_counts_plain_windows_and_launches_nothing(fixture_gi):
    cfg = VarigraphConfig(device="cpu", granularity_bp=500_000)
    before = timing.counters()
    res = et.genotype_torch(fixture_gi, cfg, 10.0, 0, device="cpu")
    moved = timing.counters_since(before)
    assert res
    assert moved["prep.plain_windows"] == len(list(_windows(fixture_gi, cfg)))
    assert not {"prep.card_windows", "launches.hap_mass",
                "launches.gather_rows"} & set(moved)
    tables = fixture_gi.prep_tables
    assert tables is not None and tables.device.type == "cpu"
    et.genotype_torch(fixture_gi, cfg, 10.0, 0, device="cpu")
    assert fixture_gi.prep_tables is tables


# --------------------------------------------------------- argument checks

def _valid_gather():
    table, tbl_csr, windows = make_case(1, 65, 20, G=2)
    tables = PrepTables.upload(table, tbl_csr)
    nodes, top, used = _group_inputs(tables, windows)
    G, N = nodes.shape
    return [*_outputs(G, N, used.shape[1]), nodes, top, used, tables, table.cov]


@pytest.mark.parametrize("i", range(10))
def test_gather_wrong_dtype_is_an_error(i):
    args = _valid_gather()
    args[i] = args[i].to(torch.float32)
    with pytest.raises(TypeError):
        prep_cuda.gather_rows_(*args)


@pytest.mark.parametrize("i", [0, 5, 6, 7, 8, 9])
def test_gather_wrong_shape_is_an_error(i):
    args = _valid_gather()
    args[i] = args[i][:1]
    with pytest.raises(ValueError):
        prep_cuda.gather_rows_(*args)


def test_gather_checks_k_contiguity_and_the_tables():
    args = _valid_gather()
    wide = list(args)
    G, N, _, Ww = args[4].shape
    wide[:7] = _outputs(G, N, 32 * Ww)
    wide[4] = torch.zeros((G, N, K + 1, Ww), dtype=torch.int32)
    with pytest.raises(ValueError, match="K must be"):
        prep_cuda.gather_rows_(*wide)
    strided = list(args)
    strided[7] = torch.cat([args[7], args[7]], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        prep_cuda.gather_rows_(*strided)
    bad = list(args)
    bad[10] = object()
    with pytest.raises(TypeError, match="PrepTables"):
        prep_cuda.gather_rows_(*bad)
    bad = list(args)
    bad[11] = args[11][:-1]
    with pytest.raises(ValueError, match="cov"):
        prep_cuda.gather_rows_(*bad)


def test_mass_checks_its_arguments():
    table, tbl_csr, windows = make_case(1, 65, 20, G=2)
    tables = PrepTables.upload(table, tbl_csr)
    nodes = _group_inputs(tables, windows)[0]
    with pytest.raises(ValueError, match="65 haplotypes"):
        prep_cuda.hap_mass_(torch.zeros((2, 64), dtype=torch.int64), nodes,
                            tables, table.cov)
    with pytest.raises(TypeError, match="out must be"):
        prep_cuda.hap_mass_(torch.zeros((2, 65), dtype=torch.int32), nodes,
                            tables, table.cov)
    with pytest.raises(ValueError, match="nodes must have shape"):
        prep_cuda.hap_mass_(torch.zeros((2, 65), dtype=torch.int64), nodes[:1],
                            tables, table.cov)
    before = prep_cuda.LAUNCHES["hap_mass"]
    prep_cuda.hap_mass_(torch.zeros((2, 65), dtype=torch.int64), nodes, tables,
                        table.cov)
    assert prep_cuda.LAUNCHES["hap_mass"] == before


# ------------------------------------------------------------------ the card

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(table, tbl_csr):
    card = KmerTable.from_numpy(table.keys_host, table.cov.numpy(), table.freq,
                                table.hapbits, table.refflag, table.nhap, "cuda")
    return card, PrepTables.upload(card, tbl_csr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernels_match_plain(name):
    _need_card()
    table, tbl_csr, windows = make_case(7, **CASES[name])
    want_m = run_mass(PrepTables.upload(table, tbl_csr), table.cov, windows)
    want_g = run_gather(PrepTables.upload(table, tbl_csr), table.cov, windows)
    card, tables = _on_card(table, tbl_csr)
    before = dict(prep_cuda.LAUNCHES)
    got_m = run_mass(tables, card.cov, windows, "cuda")
    got_g = run_gather(tables, card.cov, windows, "cuda")
    assert prep_cuda.LAUNCHES["hap_mass"] == before.get("hap_mass", 0) + 1
    assert prep_cuda.LAUNCHES["gather_rows"] == before.get("gather_rows", 0) + 1
    np.testing.assert_array_equal(got_m, want_m)
    for g_, w_ in zip(got_g, want_g):
        np.testing.assert_array_equal(g_, w_)
    again = run_gather(tables, card.cov, windows, "cuda")
    assert all(np.array_equal(a, b) for a, b in zip(again, got_g))
    np.testing.assert_array_equal(run_mass(tables, card.cov, windows, "cuda"), got_m)


@pytest.mark.cuda
def test_cuda_engine_takes_the_card_route(fixture_gi):
    """On the committed graph on the card: every window through the
    kernels (one mass launch a window, one gather a group), none through the
    plain versions, the tables copied once, and the gathered rows equal to
    the CPU route's."""
    _need_card()
    gi = _engine_on("cuda", fixture_gi)
    cfg = VarigraphConfig(device="cuda", granularity_bp=500_000)
    windows = len(list(_windows(gi, cfg)))
    for run in range(2):
        before = timing.counters()
        res = et.genotype_torch(gi, cfg, 10.0, 0)
        moved = timing.counters_since(before)
        assert res
        assert moved["prep.card_windows"] == moved["launches.hap_mass"] == windows
        assert moved["launches.gather_rows"] == moved["launches.emissions"] >= 1
        assert "prep.plain_windows" not in moved
        tables = gi.prep_tables
        assert tables is not None and tables.device.type == "cuda"
        if run == 0:
            first = tables
        assert tables is first
    host = PrepTables.upload(fixture_gi.table, fixture_gi.graph.tbl_csr)
    a = [p for p, _ in _preps(gi, cfg, tables)]
    b = [p for p, _ in _preps(fixture_gi, cfg, host)]
    for g_, w_ in zip(et._gather_group(a, tables, gi.table.cov),
                      et._gather_group(b, host, fixture_gi.table.cov)):
        assert g_.dtype == w_.dtype and torch.equal(g_.cpu(), w_)


@pytest.mark.cuda
def test_cuda_groups_prepped_ahead_give_one_groups_calls(fixture_gi, monkeypatch):
    """Several groups, each prepped on the worker while the calling thread
    scores the one before (the launches of both threads on one stream), give
    the calls of one group exactly."""
    _need_card()
    gi = _engine_on("cuda", fixture_gi)
    cfg = VarigraphConfig(device="cuda", granularity_bp=250_000)
    base = et.genotype_torch(gi, cfg, 10.0, 0)
    before = timing.counters()
    monkeypatch.setattr(et, "_WINDOW_GROUP", 2)
    got = et.genotype_torch(gi, cfg, 10.0, 0)
    moved = timing.counters_since(before)
    assert moved["launches.gather_rows"] == -(-moved["prep.card_windows"] // 2) > 1
    assert set(got) == set(base) and base
    for k in base:
        assert got[k].hap_vec == base[k].hap_vec, k
        assert got[k].probability == base[k].probability, k
        assert got[k].kmer_num_vec == base[k].kmer_num_vec, k
        assert got[k].uk == base[k].uk, k


if __name__ == "__main__":
    # writes the JAX engine's reference on the committed graph
    with open(REFERENCE, "w") as fh:
        json.dump(jax_reference(), fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {REFERENCE}")
