"""Construct phase: FASTA + VCF -> GraphIndex with the k-mer table on a torch
device.

Port of ``varigraph_tpu/index/build.py``.  Pipeline (reference call stack,
SURVEY.md section 3.1):
  1. read FASTA                       (build_fasta_index)
  2. VCF -> graph nodes               (construct, host)
  3. per-node haplotype contexts     (host walk, before any device work)
  4. genome k-mer frequencies        (make_mbf: the counting Bloom filter
                                      kernel csrc/cbf.cu on each
                                      chromosome's base codes, split
                                      over the mesh's devices from
                                      _CBF_SHARD_MIN cells when it has
                                      several; otherwise above
                                      _CBF_DEVICE_MAX cells an exact count
                                      through csrc/sketch.cu's count_codes)
  5. context sketch + CBF counts     (device: csrc/sketch.cu's context
                                      sketch, the dedup in torch),
                                      per-node aggregation and the global
                                      merge (host numpy, copied)
  6. graph2node                      (node k-mers -> table indices)

Semantics preserved from reference src/construct_index.cpp:592-699,1125-1248:
  * per-haplotype context = allele +- (k-1) bases walked through the graph
  * per-node keep rule: MIN_KMER_FRE = min CBF frequency over all context
    k-mers (forced to 1 if 0 or --use-unique-kmers); keep freq <= MIN
  * global merge in node order: f increments per node (saturating), hap
    bitmaps OR; single-node k-mers with CBF freq >= 2 get f = CBF freq
  * ref flag: k-mer present in the genome CBF, carried by a non-REF allele,
    and absent from the node's REF-path (haplotype 0) context
    (construct_index.cpp:1211-1215)
  * additionally stores per-node local haplotype bitmasks (which haplotypes'
    contexts contain each k-mer AT THIS node), which the genotype phase
    gathers instead of re-sketching contexts (genotype.cpp:725-812).

The output is the same graph, table and .vgt as the JAX package's for the
same inputs, k and seed: the filter, hash seeds and sizing are the same, and
the sharding and exact-count switches sit at the same numbers of cells.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import VarigraphConfig
from ..io.fasta import _open_text, read_fasta
from ..ops.cbf import CountingBloomFilter, ShardedCBF, cbf_size
from ..ops.exact_count import ExactGenomeCounter
from ..ops.sketch import encode_contexts
from ..ops.sketch_cuda import sketch_contexts
from ..ops.sketch_ref import encode_bases_np
from ..ops.table import _ORDER_FLIP, KmerTable
from ..parallel.mesh import Mesh, make_mesh
from ..utils.log import log
from .graph import GenomeGraph, build_graph_from_vcf, find_node_up_down_seq
from .structs import GraphIndex

# From this many filter cells a mesh of several devices splits the filter
# over its devices by position range (ops/cbf.ShardedCBF) -- the JAX
# package's default; tests set it in-process to force the regime.
_CBF_SHARD_MIN = 1 << 31
# Above this many filter cells construct counts genome k-mers exactly
# (ops/exact_count) instead of through the Bloom filter -- the JAX package's
# default, so both packages take the same counting regime for the same
# genome and their .vgt files can match.  At 2^31 cells the filter is 2 GiB
# of the card's 80 GB; tests set this in-process to force either regime.
# One device only: a mesh of several takes the sharded filter first.
_CBF_DEVICE_MAX = 1 << 31


def make_genome_cbf(fasta_map: dict[str, str], genome_size: int, k: int,
                    seed: int, device: torch.device | str = "cpu",
                    mesh: Mesh | None = None):
    """Count k-mer frequencies of the reference genome into a CBF on
    ``device`` (reference make_mbf, construct_index.cpp:150-177).  With a
    mesh of several devices, a filter of at least ``_CBF_SHARD_MIN`` cells
    is split over them (ShardedCBF).  Otherwise a filter beyond
    ``_CBF_DEVICE_MAX`` cells is skipped: the graph's candidate k-mers are
    then counted exactly by ops/exact_count.ExactGenomeCounter."""
    log("Initiating computation of k-mer frequencies in the reference genome ...")
    n = genome_size - k + 1
    m_est = 1
    while m_est < cbf_size(n, 0.01):
        m_est *= 2
    if mesh is not None and mesh.size > 1 and m_est >= _CBF_SHARD_MIN:
        bf = ShardedCBF(n=n, p=0.01, seed=seed, mesh=mesh)
        log(f"Counting Bloom Filter sharded across {mesh.size} devices "
            f"({m_est / 2**30:.1f} GiB of counters)")
    elif m_est > _CBF_DEVICE_MAX:
        bf = ExactGenomeCounter(fasta_map, k, device=device)
        log(f"Genome k-mer frequencies will be counted exactly by a streaming "
            f"join (a Bloom filter at this scale would need "
            f"{m_est / 2**30:.1f} GiB of counters; exact counts need none)")
        return bf
    else:
        bf = CountingBloomFilter(n=n, p=0.01, seed=seed, device=device)

    for chrom, seq in fasta_map.items():
        # one copy of the chromosome's codes; the filter cuts it into the
        # genome rows (ops/cbf.genome_rows) and sketches them itself
        bf.add_codes(encode_bases_np(seq), k)
        log(f"Chromosome '{chrom}' processed successfully ...")

    log("Counting Bloom Filter constructed successfully ...")
    log(f"Counting Bloom Filter size: {bf.size}")
    log(f"Hash functions count: {bf.num_hashes}")
    log(f"Counting Bloom Filter usage rate: {bf.occupancy():.2f}")
    return bf


def context_csr(contexts: list[str], k: int,
                device: torch.device | str = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Sketch the distinct contexts on ``device``: (values int64, starts
    int64 [C + 1], both on device, and the host seconds spent encoding).
    Context c's unique k-mers, in unsigned order, are values[starts[c]:
    starts[c + 1]] (``ops/sketch_cuda.sketch_contexts``).  The contexts are
    encoded once on the host into one code buffer with offsets, unpadded."""
    log(f"Sketching {len(contexts)} distinct contexts on device ...")
    t0 = time.perf_counter()
    codes, offsets = encode_contexts(contexts)
    encode_s = time.perf_counter() - t0
    values, starts = sketch_contexts(torch.from_numpy(codes).to(device),
                                     torch.from_numpy(offsets).to(device), k)
    return values, starts, encode_s


def _sketch_contexts(contexts: list[str], k: int,
                     device: torch.device | str = "cpu") -> list[np.ndarray]:
    """Per-context unique k-mer arrays (uint64, in unsigned order): a view
    of ``context_csr``."""
    values, starts, _ = context_csr(contexts, k, device)
    v = values.cpu().numpy().view(np.uint64)
    s = starts.cpu().numpy()
    return [v[a:b] for a, b in zip(s[:-1], s[1:])]


def _walk_task_range(args):
    """Walk contexts for tasks[t_lo:t_hi]; returns locally-deduped contexts
    plus per-(task, walk) haplotype-bitmask GROUPS referencing them.

    A walk's result is shared by every haplotype with the same GT whose
    neighbor GTs match the walk's visited-node trace; instead of scanning a
    memo per haplotype (O(nhap) Python per node -- 100M iterations at
    500k nodes x 200 haps), each unique walk claims all matching haplotypes
    in one vectorized compare against the dense GT matrix, and the group is
    emitted directly as the packed bitmask the index aggregation needs.

    Module-level so multiprocessing fork workers can run it; reads the
    shared state from _PARWALK (set in the parent before forking, inherited
    copy-on-write -- no graph pickling)."""
    t_lo, t_hi = args
    graph, tasks, k, fast_mode, vcf_ploidy, debug, nbytes = _PARWALK
    contexts: list[str] = []
    ctx_id: dict[str, int] = {}
    g_task: list[int] = []
    g_cid: list[int] = []
    g_bits: list[np.ndarray] = []
    g_alt: list[bool] = []
    g_h0: list[bool] = []
    walks = hap_total = 0
    for task_id in range(t_lo, t_hi):
        chrom, node_idx, node = tasks[task_id]
        starts = graph.starts[chrom]
        nodes = graph.nodes[chrom]
        gt_mat = graph.gt_mat[chrom]
        hap_gt = np.asarray(node.hap_gt, np.int64)
        H = len(hap_gt)
        active = np.ones(H, bool)
        if fast_mode and H > 1:
            # skip alt-free sample blocks (construct_index.cpp:1152-1168):
            # a hap > 0 with GT 0 walks only if its sample block has any alt
            for lo in range(1, H, vcf_ploidy):
                if hap_gt[lo : lo + vcf_ploidy].sum() == 0:
                    active[lo : lo + vcf_ploidy] = False
        hap_total += int(active.sum())
        for gt in np.unique(hap_gt[active]):
            gt = int(gt)
            sel = np.flatnonzero(active & (hap_gt == gt))
            if gt >= len(node.seqs):
                raise ValueError(
                    f"The node '{chrom}-{node.start}' lacks sequence information "
                    f"for haplotype {gt}."
                )
            while len(sel):
                h = int(sel[0])
                t_up: list[int] = []
                t_down: list[int] = []
                up, down, alt_seq = find_node_up_down_seq(
                    h, gt, node.seqs[gt], k - 1, node_idx, starts,
                    nodes, trace_up=t_up, trace_down=t_down,
                )
                walks += 1
                # claim every remaining haplotype whose neighbor GTs match
                # this walk's trace (gt_mat is 0-padded, matching the
                # missing-haplotype -> REF default)
                m = np.ones(len(sel), bool)
                for j, g in enumerate(t_up):
                    m &= gt_mat[node_idx - 1 - j, sel] == g
                for j, g in enumerate(t_down):
                    m &= gt_mat[node_idx + 1 + j, sel] == g
                m[0] = True  # the walked haplotype always owns its result
                assigned = sel[m]
                sel = sel[~m]
                if debug:  # reference -D trace (construct_index.cpp:1189-1191)
                    import sys

                    for hp in assigned:
                        sys.stderr.write(
                            f"Node Start:{node.start}, Haplotype:{int(hp)}, "
                            f"GT:{gt}, Upstream:{up}, Current:{alt_seq}, "
                            f"Downstream:{down}\n"
                        )
                ctx = up + alt_seq + down
                cid = ctx_id.get(ctx)
                if cid is None:
                    cid = len(contexts)
                    ctx_id[ctx] = cid
                    contexts.append(ctx)
                row = np.zeros(nbytes, np.uint8)
                np.bitwise_or.at(
                    row, assigned >> 3,
                    (np.uint8(1) << (assigned & 7).astype(np.uint8)),
                )
                g_task.append(task_id)
                g_cid.append(cid)
                g_bits.append(row)
                g_alt.append(gt != 0)
                g_h0.append(int(assigned[0]) == 0)
    groups = (
        np.asarray(g_task, np.int64),
        np.asarray(g_cid, np.int64),
        np.stack(g_bits) if g_bits else np.zeros((0, nbytes), np.uint8),
        np.asarray(g_alt, bool),
        np.asarray(g_h0, bool),
    )
    return contexts, groups, walks, hap_total


_PARWALK = None  # (graph, tasks, k, fast_mode, vcf_ploidy, debug, nbytes)


def collect_contexts(graph: GenomeGraph, k: int, vcf_ploidy: int,
                     fast_mode: bool, debug: bool = False, threads: int = 1,
                     tasks: list[tuple] | None = None):
    """Phase A of graph indexing: walk every (node, haplotype) context of
    every variant node (or of ``tasks``, (chrom, node index, node) triples).

    Pure host work that touches no torch op: run it BEFORE any device
    computation.  The -t fork pool's workers must not use CUDA (a forked
    child cannot), and forking before the first device op keeps them clear
    of its threads and locks.

    Returns (tasks, contexts, groups) where groups =
    (g_task, g_cid, g_bits, g_alt, g_h0) numpy arrays, one row per unique
    walk result: the task it belongs to, its context string id, the packed
    bitmask of haplotypes sharing it, whether its GT is non-REF, and
    whether haplotype 0 is among them."""
    if tasks is None:
        tasks = [(chrom, node_idx, node)
                 for chrom in sorted(graph.nodes.keys())
                 for node_idx, node in enumerate(graph.nodes[chrom])
                 if node.is_variant]

    # The walker is deterministic given (gt, GTs at its visited node range)
    # -- see find_node_up_down_seq.  Population VCFs have far fewer distinct
    # local GT signatures than haplotypes, so each unique walk claims all
    # matching haplotypes vectorized, and the resulting context strings are
    # deduplicated globally before device sketching (the reference re-walks
    # every haplotype, construct_index.cpp:1139-1186).
    width = max((g.shape[1] for g in graph.gt_mat.values()), default=1)
    nbytes = (width + 7) // 8
    global _PARWALK
    _PARWALK = (graph, tasks, k, fast_mode, vcf_ploidy, debug, nbytes)
    n_workers = 1
    if threads > 1 and not debug and len(tasks) >= 256:
        n_workers = min(threads, os.cpu_count() or 1)
    if n_workers > 1 and hasattr(os, "fork"):
        # task-parallel walking (the reference submits one pool task per
        # node, construct_index.cpp:608-631); fork workers inherit the graph
        # copy-on-write, each walks a contiguous task range, and the parent
        # merges + globally dedups the context strings
        import multiprocessing as mp

        bounds = np.linspace(0, len(tasks), n_workers * 4 + 1).astype(int)
        ranges = [
            (int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1)
            if bounds[i] < bounds[i + 1]
        ]
        log(f"Walking haplotype contexts with {n_workers} processes ...")
        with mp.get_context("fork").Pool(n_workers) as pool:
            results = pool.map(_walk_task_range, ranges)
    else:
        results = [_walk_task_range((0, len(tasks)))]
    _PARWALK = None

    contexts: list[str] = []        # unique context strings
    ctx_id: dict[str, int] = {}
    part_groups = []
    walks = hap_total = 0
    for l_ctx, l_groups, l_walks, l_haps in results:
        remap = np.empty(len(l_ctx), np.int64)
        for i, ctx in enumerate(l_ctx):
            cid = ctx_id.get(ctx)
            if cid is None:
                cid = len(contexts)
                ctx_id[ctx] = cid
                contexts.append(ctx)
            remap[i] = cid
        l_task, l_cid, l_bits, l_alt, l_h0 = l_groups
        part_groups.append(
            (l_task, remap[l_cid] if len(l_cid) else l_cid, l_bits, l_alt, l_h0)
        )
        walks += l_walks
        hap_total += l_haps
    del ctx_id
    groups = tuple(
        np.concatenate([p[i] for p in part_groups])
        if part_groups else np.empty(0)
        for i in range(5)
    )
    if hap_total > walks:
        log(f"Graph walks: {walks} unique / {hap_total} total "
            f"({len(contexts)} distinct contexts)")
    return tasks, contexts, groups


def index_graph(walked, bf, k: int, nhap: int, use_unique_kmers: bool,
                device: torch.device | str = "cpu"):
    """Build per-node k-mer sets and the global k-mer arrays.

    walked: collect_contexts' (tasks, contexts, groups), walked before the
    first device op.  bf: the genome counter (CountingBloomFilter or
    ExactGenomeCounter).
    Returns (keys u64, freq u8, hapbit_bytes [M, ceil(nhap/8)] packed u8,
    refflag bool), keys sorted.  Side effect: fills node.kmer_hashes and
    node.local_bits (packed uint8 [n_kmers, ceil(nhap/8)]).
    """
    log("Initiating the construction of the graph index ...")

    tasks, contexts, groups = walked
    g_task, g_cid, g_bits, g_alt, g_h0 = groups

    # ---- device sketch + genome-frequency counts ----
    _t0 = time.perf_counter()

    def _step(label):
        nonlocal _t0
        t = time.perf_counter()
        log(f"aggregation: {label} ({t - _t0:.2f}s)", func="index_graph")
        _t0 = t

    # the CSR of the per-context unique k-mers (all_kmers is their flat
    # concatenation in context order; ctx_starts its offsets), then the
    # global dedup on the same device, in unsigned order (sign bit
    # flipped): return_inverse lands the frequencies context-aligned out
    # of the dedup sort, with no search of every entry
    values, starts, encode_s = context_csr(contexts, k, device)
    uniq, inverse = torch.unique(values ^ _ORDER_FLIP, sorted=True,
                                 return_inverse=True)
    all_kmers = values.cpu().numpy().view(np.uint64)
    ctx_starts = starts.cpu().numpy()
    ctx_len = np.diff(ctx_starts)
    uniq_kmers = (uniq ^ _ORDER_FLIP).cpu().numpy().view(np.uint64)
    inverse = inverse.cpu().numpy()
    del values, starts, uniq
    _step(f"context sketch + dedup ({len(uniq_kmers) / 1e6:.1f}M uniq k-mers "
          f"of {len(all_kmers) / 1e6:.1f}M context k-mers; host encode "
          f"{encode_s:.2f}s)")
    uniq_counts = bf.count(uniq_kmers) if len(uniq_kmers) else np.empty(0, np.uint8)
    ctx_fre = uniq_counts[inverse].astype(np.int64)  # aligned with all_kmers
    _step("genome k-mer frequencies")

    # ---- vectorized per-node aggregation + global merge ----
    # The walk already collapsed haplotypes into (task, walk-result) groups
    # (hap bitmask + has-alt/has-hap0 flags, collect_contexts); entry arrays
    # carry one row per (group, kmer) instead of per (haplotype, kmer) --
    # for population VCFs this is a ~nhap-fold reduction in sort/merge work.
    nbytes = (nhap + 7) // 8
    if len(g_task) and g_bits.shape[1] != nbytes:
        fixed = np.zeros((g_bits.shape[0], nbytes), np.uint8)
        w = min(nbytes, g_bits.shape[1])
        fixed[:, :w] = g_bits[:, :w]
        g_bits = fixed

    glen = ctx_len[g_cid] if len(g_cid) else np.empty(0, np.int64)
    if glen.sum() == 0:
        for _, _, node in tasks:
            node.kmer_hashes = np.empty(0, np.uint64)
            node.local_bits = np.zeros((0, nbytes), np.uint8)
        return (np.empty(0, np.uint64), np.empty(0, np.uint8),
                np.zeros((0, nbytes), np.uint8), np.empty(0, bool))
    # expand each group's context k-mer range (vectorized CSR expansion: no
    # million-array concatenate, no per-entry searchsorted)
    e_task = np.repeat(g_task, glen)
    e_gidx = np.repeat(np.arange(len(g_task), dtype=np.int64), glen)
    gcum = np.zeros(len(glen), np.int64)
    np.cumsum(glen[:-1], out=gcum[1:])
    e_ofs = np.repeat(ctx_starts[g_cid] - gcum, glen) + np.arange(
        int(glen.sum()), dtype=np.int64
    )
    e_kh = all_kmers[e_ofs]
    e_fre = ctx_fre[e_ofs]
    del e_ofs
    _step(f"entry expansion (E={len(e_kh) / 1e6:.1f}M)")

    # ONE k-mer-major sort: pairs = unique (kmer, task) runs, AND the kept
    # subset comes out already hash-sorted, so the global merge below needs
    # no second 64-bit sort (the former task-major formulation paid a full
    # extra argsort over the kept entries)
    order = np.lexsort((e_task, e_kh))
    e_task, e_kh, e_gidx, e_fre = (
        e_task[order], e_kh[order], e_gidx[order], e_fre[order]
    )
    del order
    _step("(kmer, task) lexsort")
    new_pair = np.empty(len(e_kh), bool)
    new_pair[0] = True
    new_pair[1:] = (e_kh[1:] != e_kh[:-1]) | (e_task[1:] != e_task[:-1])
    starts = np.flatnonzero(new_pair)

    # per-pair haplotype bitmask: OR of the context groups' bit rows
    pair_bits = np.bitwise_or.reduceat(g_bits[e_gidx], starts, axis=0)
    pair_task = e_task[starts]
    pair_kh = e_kh[starts]
    pair_fre = e_fre[starts]
    # ref flag (construct_index.cpp:1211-1215): genome k-mer carried by a
    # non-REF allele whose REF-path (haplotype 0) context lacks it.
    has_alt = np.logical_or.reduceat(g_alt[e_gidx], starts)
    has_hap0 = np.logical_or.reduceat(g_h0[e_gidx], starts)
    pair_flag = has_alt & (pair_fre >= 1) & ~has_hap0
    _step(f"pair reduction (P={len(pair_kh) / 1e6:.1f}M)")

    # per-task minimum genome frequency -> keep rule
    ntasks = len(tasks)
    minfre = np.full(ntasks, 255, np.int64)
    np.minimum.at(minfre, pair_task, pair_fre)
    if use_unique_kmers:
        minfre[:] = 1
    else:
        minfre[minfre == 0] = 1
    kept_mask = pair_fre <= minfre[pair_task]

    k_task = pair_task[kept_mask]
    k_kh = pair_kh[kept_mask]    # still k-mer-major sorted
    k_bits = pair_bits[kept_mask]
    k_flag = pair_flag[kept_mask]
    k_fre = pair_fre[kept_mask]
    _step(f"keep rule (K={len(k_kh) / 1e6:.1f}M)")

    # ---- global merge, closed form (input already hash-sorted) ----
    # The reference merges node results sequentially (construct_index.cpp:
    # 637-690): f increments once per node (saturating at 255), and right
    # after a k-mer's FIRST node the CBF frequency >= 2 is folded in while
    # f == 1 (:670-681).  For a k-mer in n nodes with genome count c this
    # yields exactly f = min(255, (c if c >= 2 else 1) + n - 1).
    kfirst = np.empty(len(k_kh), bool)
    if len(k_kh):
        kfirst[0] = True
        kfirst[1:] = k_kh[1:] != k_kh[:-1]
    kstarts = np.flatnonzero(kfirst)
    g_kh = k_kh[kstarts]
    g_n = np.diff(np.append(kstarts, len(k_kh)))
    g_fre = k_fre[kstarts]  # genome count, identical across a k-mer's nodes
    gm_bits = np.bitwise_or.reduceat(k_bits, kstarts, axis=0)
    g_flag = np.logical_or.reduceat(k_flag, kstarts)
    base = np.where(g_fre >= 2, g_fre, 1)
    g_f = np.minimum(base + g_n - 1, 255)
    _step(f"global merge (M={len(g_kh) / 1e6:.1f}M)")

    # write per-node kept k-mers: a stable integer argsort of the task ids
    # restores task-major order while preserving the hash order within each
    # task (the reference keeps node k-mer lists hash-ordered implicitly via
    # its per-node sets)
    norder = np.argsort(k_task, kind="stable")
    k_task = k_task[norder]
    node_starts = np.searchsorted(k_task, np.arange(ntasks + 1))
    nk_kh = k_kh[norder]
    nk_bits = k_bits[norder]
    for task_id, (chrom, node_idx, node) in enumerate(tasks):
        lo, hi = node_starts[task_id], node_starts[task_id + 1]
        node.kmer_hashes = nk_kh[lo:hi]   # u64 view (graph.build_kmer_csr
        node.local_bits = nk_bits[lo:hi]  # re-homes these per chromosome)
    _step("per-node assignment")

    # hap bitmaps stay packed ([M, nbytes] u8) all the way into the device
    # table -- no [M, nhap] matrix is ever materialized
    return g_kh, g_f.astype(np.uint8), gm_bits, g_flag


def build_kmer_table(arrays, nhap: int,
                     device: torch.device | str = "cpu") -> KmerTable:
    """(keys, freq, hapbit_bytes, refflag) arrays -> sorted table, keys and
    cov on ``device``."""
    keys, freq, bit_bytes, refflag = arrays
    return KmerTable.build_packed(keys, freq, bit_bytes, refflag, nhap, device)

def construct_graph_index(config: VarigraphConfig,
                          mesh: Mesh | None = None) -> GraphIndex:
    """The full construct phase (reference Varigraph::construct,
    src/varigraph.cpp:14-54), on ``config.device``.  mesh (default: every
    local device, ``make_mesh(config.mesh_devices)``): the devices a large
    genome filter is split over."""
    device = config.torch_device()
    if mesh is None:
        mesh = make_mesh(config.mesh_devices, device)
    fasta_map, len_map, genome_size = read_fasta(config.ref_file)

    log("Constructing ...")
    t0 = time.perf_counter()
    with _open_text(config.vcf_file) as fh:
        graph, vcf_head, vcf_info, hap_names, stats, extra_bases = build_graph_from_vcf(
            fh, fasta_map, config.vcf_ploidy
        )
    log(f"phase timing: vcf parse {time.perf_counter() - t0:.2f}s")

    # walk the haplotype contexts FIRST: pure host work, and the -t fork
    # pool must start before the first device op
    t0 = time.perf_counter()
    walked = collect_contexts(
        graph, config.kmer_len, config.vcf_ploidy, config.fast_mode,
        debug=config.debug, threads=config.threads,
    )
    log(f"phase timing: walk {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    bf = make_genome_cbf(fasta_map, genome_size, config.kmer_len, config.seed,
                         device, mesh)
    log(f"phase timing: genome counts {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    arrays = index_graph(walked, bf, config.kmer_len, len(hap_names),
                         config.use_unique_kmers, device=device)
    del bf  # the filter's device memory is not needed past this point
    table = build_kmer_table(arrays, len(hap_names), device)
    log(f"phase timing: index {time.perf_counter() - t0:.2f}s")

    gi = GraphIndex(
        kmer_len=config.kmer_len,
        vcf_ploidy=config.vcf_ploidy,
        graph_base_num=genome_size + extra_bases,
        genome_size=genome_size,
        hap_names=hap_names,
        chrom_lens=dict(len_map),
        vcf_head=vcf_head,
        vcf_info=vcf_info,
        graph=graph,
        table=table,
        stats=stats,
    )
    log(f"Total number of bases in the Genome Graph: {gi.graph_base_num}")
    log(f"Total number of k-mers present in the Genome Graph: {table.size}")
    log(f"Total number of haplotypes present in the Genome Graph: {gi.nhap}")

    # resolve node k-mers -> table indices now, like the reference's
    # graph2node_run inside construct (construct_index.cpp:1572-1603); the
    # result is static graph+table content and rides the .vgt
    from ..genotype.engine_np import graph2node

    t0 = time.perf_counter()
    graph2node(gi)
    log(f"graph2node precomputed ({time.perf_counter() - t0:.2f}s)",
        func="graph2node")
    return gi
