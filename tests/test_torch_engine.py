"""The torch scoring engine (varigraph_tpu_torch/genotype/engine_torch.py)
against the JAX engine (varigraph_tpu/genotype/engine_jax.py).

Tolerances and their reasons:
  * emissions: rtol 4e-6 (about 32 float32 ulp) on finite log-emissions,
    -inf at exactly the same places.  Both sides are float32; each
    log-emission is a sum of up to 128 terms taken in another order, and
    lgamma comes from another library (XLA's and torch's are each accurate
    to a few ulp).  Measured: at most 5e-7.
  * forward/backward: atol 1e-6 (about 8 ulp at 1.0) on the normalized
    alpha/beta (values in [0, 1]); float32 contractions summed in another
    order.  Measured: at most 1.2e-7.
  * whole engine: the same GT, UK and NAK at every site, GPP within 2e-3
    (the tolerance of tests/test_engine_parity.py), diploid and tetraploid.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import varigraph_tpu.genotype.engine_jax as ej  # noqa: E402
import varigraph_tpu_torch.genotype.engine_torch as et  # noqa: E402
from varigraph_tpu.config import VarigraphConfig as JaxConfig  # noqa: E402
from varigraph_tpu.genotype.counting import count_reads  # noqa: E402
from varigraph_tpu.genotype.coverage import estimate_hap_coverage  # noqa: E402
from varigraph_tpu.genotype.engine_np import graph2node as jax_graph2node  # noqa: E402
from varigraph_tpu.genotype.engine_np import get_error_param, poisson_interval  # noqa: E402
from varigraph_tpu.index.build import construct_graph_index  # noqa: E402
from varigraph_tpu.index.serialize import save_graph  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.genotype.engine_np import graph2node  # noqa: E402
from varigraph_tpu_torch.index.serialize import load_graph  # noqa: E402

from data_gen import generate_dataset  # noqa: E402

GPP_TOL = 2e-3


def _scalars(ave):
    lower, upper = poisson_interval(ave)
    p = get_error_param(ave)
    q = 1.0 - p
    log_prior = np.log(1.0 / np.sqrt(2 * np.pi * 0.05)) - (p - 0.5) ** 2 / 0.1
    return tuple(np.float32(x) for x in
                 (ave, lower, upper, np.log(p), np.log(q), log_prior))


def _random_states(rng, n_used, S, P=2):
    states = rng.integers(0, n_used, size=(S, P))
    cnt = np.zeros((32, S), np.float32)
    for s in range(S):
        for u in states[s]:
            cnt[u, s] += 1
    ov = np.zeros((S, S), np.int32)
    for i in range(S):
        for j in range(S):
            ov[i, j] = sum(min(np.sum(states[i] == u), np.sum(states[j] == u))
                           for u in range(n_used))
    return cnt, ov


@pytest.mark.parametrize("ave", [4.0, 9.5, 23.0])
def test_emissions_body_matches_jax(ave):
    rng = np.random.default_rng(int(ave * 10))
    G, Bn, K, S = 2, 6, 128, 8
    c = rng.integers(0, 3 * int(ave) + 5, size=(G, Bn, K)).astype(np.int32)
    f = rng.integers(1, 5, size=(G, Bn, K)).astype(np.int32)
    flag = rng.random((G, Bn, K)) < 0.3
    kmask = rng.random((G, Bn, K)) < 0.8
    bits = rng.integers(0, 1 << 32, size=(G, Bn, K, 1), dtype=np.uint64).astype(np.uint32)
    local = rng.integers(0, 1 << 32, size=(G, Bn, K, 1), dtype=np.uint64).astype(np.uint32)
    gt0 = rng.random((G, Bn, 32)) < 0.5
    sc = np.stack([_random_states(rng, 5, S)[0] for _ in range(G)])
    sm = np.ones((G, S), bool)
    sm[1, -3:] = False
    sc[1, :, -3:] = 0
    scal = _scalars(ave)

    want = np.asarray(ej._emissions_group(
        *(jnp.asarray(a) for a in (c, f, flag, kmask, bits, local, gt0, sc, sm)),
        *scal))
    t = torch.from_numpy
    got = et._emissions_body(
        t(c), t(f), t(flag), t(kmask), t(bits.astype(np.int64)),
        t(local.astype(np.int64)), t(gt0), t(sc), t(sm),
        *(float(x) for x in scal)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.sum() == G * Bn * S - 3 * Bn
    np.testing.assert_allclose(got[fin], want[fin], rtol=4e-6)


def _fb_inputs(seed, fre):
    rng = np.random.default_rng(seed)
    W, N, S, P = 3, 25, 6, 2
    logE = rng.normal(-40.0, 6.0, size=(W, N, S)).astype(np.float32)
    smask = np.ones((W, S), bool)
    smask[2, 4:] = False
    logE[~np.broadcast_to(smask[:, None, :], logE.shape)] = -np.inf
    kind = np.ones((W, N), np.int32)
    kind[0, [3, 4, 11]] = 2               # chain resets
    kind[1, 20:] = 0                      # pad nodes
    kind[2, 0] = 2
    dist = rng.integers(0, 200_000, size=(W, 2, N))
    dist[0, 0, 5] = 0                     # zero distance: rec = 0, log = -inf
    lrf, lnrf = ej._transition_logs(dist[:, 0], 5)
    lrb, lnrb = ej._transition_logs(dist[:, 1], 5)
    ov = np.stack([_random_states(rng, 4, S)[1] for _ in range(W)])
    w = rng.random((W, S))
    w[0, 1] = 0.0
    with np.errstate(divide="ignore"):
        log_w = np.log(w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return (logE, kind, lrf, lnrf, lrb, lnrb, ov, log_w, smask), fre, P


@pytest.mark.parametrize("fre", [False, True])
def test_forward_backward_matches_jax(fre):
    arrays, fre, P = _fb_inputs(3 + fre, fre)
    a_j, b_j = ej._forward_backward(*(jnp.asarray(a) for a in arrays),
                                    jnp.bool_(fre), P)
    a_t, b_t = et._forward_backward(*(torch.from_numpy(a) for a in arrays),
                                    fre, P)
    for got, want in ((a_t, a_j), (b_t, b_j)):
        want = np.asarray(want)
        assert np.isfinite(want).all() and want.max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- engines

def _build_indexes(out, ploidy=2, **kw):
    """The same graph and counts in both packages, built from a data_gen
    dataset of the given ploidy (graph and sample)."""
    paths, _ = generate_dataset(out, ploidy=ploidy, **kw)
    jgi = construct_graph_index(JaxConfig(ref_file=paths["ref"],
                                          vcf_file=paths["vcf"], kmer_len=27,
                                          seed=0, vcf_ploidy=ploidy))
    vgt = os.path.join(out, "graph.vgt")
    save_graph(jgi, vgt)
    jax_graph2node(jgi)
    read_base = count_reads(jgi.table, [paths["fq"]], 27, 16384, 160,
                            n_devices=1)
    hap_cov = estimate_hap_coverage(
        jgi.table.cov_u8(), jgi.table.freq_np(), jgi.table.hap_words_np(),
        jgi.nhap, jgi.vcf_ploidy, ploidy, read_base / jgi.genome_size, False)

    tgi = load_graph(vgt, device="cpu")
    graph2node(tgi)
    tgi.table.cov.copy_(torch.from_numpy(np.asarray(jgi.table.cov).astype(np.int32)))
    return jgi, tgi, hap_cov


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The same graph and counts in both packages."""
    return _build_indexes(str(tmp_path_factory.mktemp("engine")), seed=21,
                          chrom_lens={"chr1": 6000}, n_variants=25,
                          samples=("S1", "S2"), depth=30.0)


@pytest.fixture(scope="module")
def indexes_tetraploid(tmp_path_factory):
    """A tetraploid graph and sample, as tests/test_modes.py builds the JAX
    package's."""
    return _build_indexes(str(tmp_path_factory.mktemp("engine4")), ploidy=4,
                          seed=31, chrom_lens={"chr1": 4000}, n_variants=15,
                          samples=("S1", "S2"), depth=40.0)


def _gts(gi, res):
    node_at = {(c, n.start): n for c in gi.graph.nodes for n in gi.graph.nodes[c]}
    return {k: sorted(int(node_at[k].hap_gt[h]) for h in r.hap_vec)
            for k, r in res.items()}


def _configs(mode, sample_type, granularity, ploidy=2):
    kw = dict(transition_pro_type=mode, sample_type=sample_type,
              granularity_bp=granularity, seed=0, vcf_ploidy=ploidy,
              sample_ploidy=ploidy)
    return JaxConfig(**kw), VarigraphConfig(device="cpu", **kw)


@pytest.mark.parametrize("mode,sample_type,granularity,ploidy", [
    ("rec", "het", 1_000_000, 2), ("fre", "het", 1_000_000, 2),
    ("rec", "hom", 1_000_000, 2), ("rec", "het", 1000, 2),
    ("rec", "het", 1_000_000, 4)])
def test_genotype_torch_matches_jax(request, mode, sample_type, granularity,
                                    ploidy):
    jgi, tgi, hap_cov = request.getfixturevalue(
        "indexes_tetraploid" if ploidy == 4 else "indexes")
    jcfg, tcfg = _configs(mode, sample_type, granularity, ploidy)
    want = ej.genotype_jax(jgi, jcfg, hap_cov, 0)
    got = et.genotype_torch(tgi, tcfg, hap_cov, 0, device="cpu")
    assert set(got) == set(want) and want
    assert _gts(tgi, got) == _gts(jgi, want)
    for k in want:
        assert got[k].uk == want[k].uk, k
        assert got[k].kmer_num_vec == want[k].kmer_num_vec, k
        assert abs(got[k].probability - want[k].probability) <= GPP_TOL, k


def test_grouping_and_node_chunking_do_not_change_calls(indexes, monkeypatch):
    """One window per group, and a node chunk far below the window's node
    count (the path for windows above _EMIT_ROWS nodes), give the default
    path's results exactly."""
    _, tgi, hap_cov = indexes
    _, tcfg = _configs("rec", "het", 1000)
    base = et.genotype_torch(tgi, tcfg, hap_cov, 0, device="cpu")
    monkeypatch.setattr(et, "_WINDOW_GROUP", 1)
    monkeypatch.setattr(et, "_EMIT_ROWS", 1)
    monkeypatch.setattr(et, "_NODE_CHUNK", 2)
    got = et.genotype_torch(tgi, tcfg, hap_cov, 0, device="cpu")
    assert set(got) == set(base) and base
    for k in base:
        assert got[k].hap_vec == base[k].hap_vec, k
        assert abs(got[k].probability - base[k].probability) < 1e-6, k
