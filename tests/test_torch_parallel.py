"""The device mesh of the torch port (varigraph_tpu_torch/parallel/mesh.py and
its users) against the JAX package's (varigraph_tpu/parallel/mesh.py) on the
CPU: n logical shards of the one CPU device stand for n devices.

  * ShardedCBF: filter bytes and counts equal to the JAX sharded add and
    count on the same mesh size and to the one-device filter, at 2, 4 and 8
    shards (m a power of two) and at 3 (m padded to a multiple of 3, modulo
    addressing, shards of a size that is not a multiple of 4);
  * construct with the shard threshold forced: every .vgt member equal to
    the JAX package's sharded construct;
  * replicated-table counting: coverage equal to one device's;
  * window-sharded forward/backward: the same GT, UK and NAK as one device,
    GPP within 2e-3 (the engine parity tolerance)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import varigraph_tpu.index.build as jax_build  # noqa: E402
import varigraph_tpu_torch.index.build as torch_build  # noqa: E402
from varigraph_tpu.ops.cbf import CountingBloomFilter as JaxCBF  # noqa: E402
from varigraph_tpu.ops.cbf import ShardedCBF as JaxShardedCBF  # noqa: E402
from varigraph_tpu.parallel import mesh as jax_mesh  # noqa: E402
from varigraph_tpu_torch.config import VarigraphConfig  # noqa: E402
from varigraph_tpu_torch.ops.cbf import (  # noqa: E402
    CountingBloomFilter, ShardedCBF)
from varigraph_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402

from data_gen import generate_dataset  # noqa: E402
from test_torch_construct import assert_same_vgt  # noqa: E402

CPU = torch.device("cpu")


def _filter_case():
    """(n, adds [(keys, mask)], queries): 2,000 keys with duplicates (counters
    above 1), half of them with bit 63 set, a 90% mask."""
    rng = np.random.default_rng(17)
    keys = rng.integers(1, 1 << 60, size=2048, dtype=np.uint64)
    keys[::2] |= np.uint64(1 << 63)
    keys[1024:] = keys[:1024]
    mask = rng.random(2048) < 0.9
    queries = np.concatenate([keys, rng.integers(1, 1 << 62, size=500,
                                                 dtype=np.uint64)])
    return 4096, [(keys, mask), (keys[:300], np.ones(300, bool))], queries


def test_mesh_basics():
    assert make_mesh(0, "cpu").devices == (CPU,)
    assert make_mesh(4, "cpu").size == 1
    mesh = Mesh(["cpu"] * 3)
    assert mesh.size == 3 and set(mesh.devices) == {CPU}
    with pytest.raises(ValueError):
        Mesh([])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_cbf_matches_jax_and_one_device(n_shards):
    n, adds, queries = _filter_case()
    one = CountingBloomFilter(n, 0.01, seed=3)
    sh = ShardedCBF(n, 0.01, seed=3, mesh=Mesh(["cpu"] * n_shards))
    assert (sh.size, sh.num_hashes) == (one.size, one.num_hashes)
    np.testing.assert_array_equal(sh.seeds, one.seeds)

    jmesh = jax_mesh.make_mesh(n_shards)
    jbf = JaxCBF(n=n, p=0.01, seed=3)
    add = jax_mesh.make_cbf_add_sharded(jmesh, jbf.size, jbf.num_hashes)
    count = jax_mesh.make_cbf_count_sharded(jmesh, jbf.size, jbf.num_hashes)
    filt = jax.device_put(jnp.zeros(jbf.size, jnp.uint8),
                          jax.sharding.NamedSharding(
                              jmesh, jax.sharding.PartitionSpec("data")))
    for keys, mask in adds:
        sh.add(keys, mask)
        one.add(keys, mask)
        filt = add(filt, jnp.asarray(keys), jnp.asarray(mask),
                   jnp.asarray(jbf.seeds))
        np.testing.assert_array_equal(sh.filter_np(), np.asarray(filt))
        np.testing.assert_array_equal(sh.filter_np(), one.filter.numpy())
    got = sh.count(queries)
    np.testing.assert_array_equal(
        got, np.asarray(count(filt, jnp.asarray(queries),
                              jnp.asarray(jbf.seeds))))
    np.testing.assert_array_equal(got, one.count(queries))
    np.testing.assert_array_equal(sh.find(queries), got > 0)
    assert sh.occupancy() == one.occupancy()


def test_sharded_cbf_three_shards_matches_jax():
    """A 3-shard mesh: m = 2^16 + 2 (2^16 padded to a multiple of 3),
    positions modulo m, shards of 21,846 cells (not a multiple of 4)."""
    n, adds, queries = _filter_case()
    sh = ShardedCBF(n, 0.01, seed=5, mesh=Mesh(["cpu"] * 3))
    jsh = JaxShardedCBF(n, 0.01, seed=5, mesh=jax_mesh.make_mesh(3))
    assert sh.size == jsh.size == (1 << 16) + 2 == 3 * sh.m_local
    assert sh.m_local % 4 and sh.num_hashes == jsh.num_hashes
    for keys, mask in adds:
        sh.add(keys, mask)
        jsh.add(keys, mask)
        np.testing.assert_array_equal(sh.filter_np(), np.asarray(jsh.filter))
    np.testing.assert_array_equal(sh.count(queries), jsh.count(queries))
    assert sh.occupancy() == pytest.approx(jsh.occupancy(), abs=0)
    # a counter past 1 in every shard, and the padding bytes untouched
    for shard in sh.shards:
        assert int(shard.max()) > 1
        whole = torch.empty(0, dtype=torch.uint8).set_(shard.untyped_storage())
        assert whole.numel() % 4 == 0 and whole.numel() > shard.numel()
        assert not whole[shard.numel():].any()


def test_sharded_construct_matches_jax(tmp_path, monkeypatch):
    """construct with _CBF_SHARD_MIN = 1 on a 2-shard mesh writes the .vgt
    of the JAX package's sharded construct (over its 8 CPU devices)."""
    from varigraph_tpu.config import VarigraphConfig as JaxConfig
    from varigraph_tpu.index.serialize import save_graph as jax_save
    from varigraph_tpu_torch.index.serialize import save_graph

    paths, _ = generate_dataset(str(tmp_path), seed=31,
                                chrom_lens={"chr1": 5000}, n_variants=15,
                                samples=("S1",), depth=5.0)
    made = []

    class Recording(ShardedCBF):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jax_build, "_CBF_SHARD_MIN", 1)
    monkeypatch.setattr(torch_build, "_CBF_SHARD_MIN", 1)
    monkeypatch.setattr(torch_build, "ShardedCBF", Recording)
    jax_gi = jax_build.construct_graph_index(JaxConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0))
    jax_save(jax_gi, str(tmp_path / "jax.vgt"))
    gi = torch_build.construct_graph_index(
        VarigraphConfig(ref_file=paths["ref"], vcf_file=paths["vcf"],
                        kmer_len=27, seed=0, device="cpu"),
        mesh=Mesh(["cpu"] * 2))
    save_graph(gi, str(tmp_path / "torch.vgt"))
    assert len(made) == 1 and len(made[0].shards) == 2
    assert_same_vgt(str(tmp_path / "torch.vgt"), str(tmp_path / "jax.vgt"))


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A 16 kb chromosome of 40 sites (8 windows at 2 kb granularity), its
    port-built graph and 30x reads."""
    from varigraph_tpu_torch.genotype.engine_np import graph2node

    out = str(tmp_path_factory.mktemp("torch_parallel"))
    paths, _ = generate_dataset(out, seed=57, chrom_lens={"chr1": 16000},
                                n_variants=40, samples=("S1", "S2"),
                                depth=30.0)
    gi = torch_build.construct_graph_index(VarigraphConfig(
        ref_file=paths["ref"], vcf_file=paths["vcf"], kmer_len=27, seed=0,
        device="cpu"))
    graph2node(gi)
    return gi, paths


@pytest.mark.parametrize("n_shards", [2, 4])
def test_replicated_counting_matches_one_device(scored, n_shards):
    """Batches of 256 reads go round-robin over the shards; the summed
    deltas are the one-device coverage."""
    from varigraph_tpu_torch.genotype.counting import count_reads

    gi, paths = scored
    gi.table.reset_cov()
    bases = count_reads(gi.table, [paths["fq"]], 27, 256, 160)
    want = gi.table.cov.clone()
    gi.table.reset_cov()
    assert count_reads(gi.table, [paths["fq"]], 27, 256, 160,
                       mesh=Mesh(["cpu"] * n_shards)) == bases
    assert int(want.sum()) > 0
    assert torch.equal(gi.table.cov, want)
    gi.table.reset_cov()


@pytest.mark.parametrize("n_shards", [2, 3])
def test_window_sharded_scoring_matches_one_device(scored, n_shards):
    """granularity 2 kb: 8 windows in one group, split 4/4 or 3/3/2."""
    from varigraph_tpu_torch.genotype.counting import count_reads
    from varigraph_tpu_torch.genotype.coverage import estimate_hap_coverage
    from varigraph_tpu_torch.genotype.engine_torch import genotype_torch

    gi, paths = scored
    gi.table.reset_cov()
    read_base = count_reads(gi.table, [paths["fq"]], 27, 16384, 160)
    cfg = VarigraphConfig(kmer_len=27, vcf_ploidy=2, seed=0,
                          granularity_bp=2000, device="cpu")
    hap_cov = estimate_hap_coverage(
        gi.table.cov_u8(), gi.table.freq_np(), gi.table.hap_words_np(),
        gi.nhap, gi.vcf_ploidy, 2, read_base / gi.genome_size, False)
    one = genotype_torch(gi, cfg, hap_cov, 0, device="cpu")
    sharded = genotype_torch(gi, cfg, hap_cov, 0, device="cpu",
                             mesh=Mesh(["cpu"] * n_shards))
    gi.table.reset_cov()
    assert set(one) == set(sharded) and len(one) >= 20
    node_at = {(c, n.start): n for c in gi.graph.nodes for n in gi.graph.nodes[c]}
    for key, a in one.items():
        b = sharded[key]
        gt = [sorted(int(node_at[key].hap_gt[h]) for h in r.hap_vec)
              for r in (a, b)]
        assert gt[0] == gt[1], key
        assert a.uk == b.uk and a.kmer_num_vec == b.kmer_num_vec, key
        assert abs(a.probability - b.probability) <= 2e-3, key
