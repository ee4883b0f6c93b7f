"""Saving and loading a graph (.vgt).

A port of ``varigraph_tpu/index/serialize.py``: a .vgt is an npz bundle
carrying the header (graph base count, k, vcf ploidy), the VCF head
and per-site column mirror with chromosome lengths, the haplotype registry,
every graph node (allele sequences, per-haplotype GTs, per-node k-mer hashes
and local haplotype bitmasks), the precomputed node -> table CSR, and the
global k-mer table.  ``save_graph`` writes the same members, dtypes, stored
or deflated choice and ``meta`` JSON as the JAX package, so either package
loads the other's file.  On load the table's keys and coverage go to
``device``; the rest stays host numpy.  ``load_graph`` reads the reference
binary's graph.bin too (index/interop.py): any file that is not a zip.
"""

from __future__ import annotations

import json
import time
import zipfile
import zlib

import numpy as np
import torch

from ..ops.table import KmerTable
from ..utils.log import log
from .graph import GenomeGraph, RefSpan, VariantStats
from .structs import GraphIndex

_MAGIC = "varigraph-tpu-graph"
_VERSION = 1

# members stored WITHOUT deflate: u64 hash arrays are ~incompressible
# (hash64/Murmur outputs), so deflating them costs CPU for nothing -- at
# the 1 Gbp scale kmer_flat + tbl_keys are ~600 MB of the write.
# tbl_bits (dense per-key hap words at production hap counts) measured
# 26 s of deflate for a 0.87 compression ratio at 1 Gbp / 201 haps
# (tools/save_profile.py) -- the single largest save cost, for nothing.
_STORED_MEMBERS = frozenset({"kmer_flat", "tbl_keys", "tbl_bits"})


def _savez_level1(fh, **arrays) -> None:
    """np.savez_compressed with deflate level 1: same .npz container
    (np.load-compatible) but ~10x faster to write -- savez_compressed's
    fixed level 6 took 101 s for a 300 Mb genome's graph.  Known-high-
    entropy members are STORED raw (see _STORED_MEMBERS)."""
    with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED, allowZip64=True,
                         compresslevel=1) as zf:
        for name, arr in arrays.items():
            if name in _STORED_MEMBERS:
                zi = zipfile.ZipInfo(f"{name}.npy")
                zi.compress_type = zipfile.ZIP_STORED
                with zf.open(zi, "w", force_zip64=True) as member:
                    np.lib.format.write_array(member, np.asanyarray(arr))
            else:
                with zf.open(f"{name}.npy", "w", force_zip64=True) as member:
                    np.lib.format.write_array(member, np.asanyarray(arr))


def save_graph(gi: GraphIndex, path: str) -> None:
    _t0 = time.perf_counter()
    log(f"Genome Graph index saved to file: {path}")
    chroms = sorted(gi.graph.nodes.keys())
    chrom_of = {c: i for i, c in enumerate(chroms)}

    node_chrom: list[int] = []
    node_start: list[int] = []
    node_nseq: list[int] = []
    node_ngt: list[int] = []
    node_nkmer: list[int] = []
    seq_lens: list[int] = []
    seq_parts: list[bytes] = []
    gt_parts: list[np.ndarray] = []
    kmer_parts: list[np.ndarray] = []
    local_bits_rows: list[np.ndarray] = []

    nbytes = (gi.nhap + 7) // 8
    for c in chroms:
        for n in gi.graph.nodes[c]:
            node_chrom.append(chrom_of[c])
            node_start.append(n.start)
            node_nseq.append(len(n.seqs))
            node_ngt.append(len(n.hap_gt))
            node_nkmer.append(len(n.kmer_hashes))
            for s in n.seqs:
                seq_lens.append(len(s))
                seq_parts.append(s.encode("ascii"))
            if len(n.hap_gt):
                gt_parts.append(np.asarray(n.hap_gt, np.uint16))
            if len(n.kmer_hashes):
                kmer_parts.append(np.asarray(n.kmer_hashes, np.uint64))
                local_bits_rows.append(
                    np.asarray(n.local_bits, np.uint8).reshape(
                        len(n.kmer_hashes), -1
                    )
                )

    gt_flat = (
        np.concatenate(gt_parts) if gt_parts else np.empty(0, np.uint16)
    )
    kmer_flat = (
        np.concatenate(kmer_parts) if kmer_parts else np.empty(0, np.uint64)
    )
    local_bits_arr = (
        np.concatenate(local_bits_rows)
        if local_bits_rows else np.zeros((0, nbytes), np.uint8)
    )

    # VCF info mirror as a compressed text blob
    vcf_lines = []
    for c, smap in gi.vcf_info.items():
        for start, cols in smap.items():
            vcf_lines.append("\t".join([c, str(start)] + cols))
    # level 1: the mirror is highly repetitive VCF text (level 6 measured
    # 16.8 s vs ~5 s at 1 Gbp for a few-MB size difference)
    vcf_info_blob = zlib.compress("\n".join(vcf_lines).encode("utf-8"), 1)

    meta = {
        "magic": _MAGIC,
        "version": _VERSION,
        "kmer_len": gi.kmer_len,
        "vcf_ploidy": gi.vcf_ploidy,
        "graph_base_num": gi.graph_base_num,
        "genome_size": gi.genome_size,
        "hap_names": gi.hap_names,
        "chroms": chroms,
        "chrom_lens": [gi.chrom_lens.get(c, 0) for c in chroms],
        "stats": vars(gi.stats),
    }

    # precomputed graph2node CSR (node k-mer -> table index resolution):
    # static content, so it ships with the graph and genotype runs skip the
    # 87.8M-row host join (244.6 s at 3 Gbp).  construct_graph_index
    # computes it before saving.
    missing = [c for c in chroms if c not in gi.graph.tbl_csr]
    if missing:
        raise ValueError(f"save_graph: no graph2node CSR for {missing[:3]}; "
                         "run genotype.engine_np.graph2node first")
    tc_off_parts, tc_idx_parts, tc_lp_parts = [], [], []
    for c in chroms:
        off, idx, lp = gi.graph.tbl_csr[c]
        tc_off_parts.append(np.asarray(off, np.int64))
        tc_idx_parts.append(np.asarray(idx, np.uint32))
        tc_lp_parts.append(
            np.asarray(lp, np.uint8).reshape(len(idx), -1) if len(idx)
            else np.zeros((0, nbytes), np.uint8)
        )
    tc_off = np.concatenate(tc_off_parts)
    tc_idx = np.concatenate(tc_idx_parts)
    tc_lp = np.concatenate(tc_lp_parts)

    fh = open(path, "wb")  # pass a handle so numpy keeps the exact filename
    _savez_level1(
        fh,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8),
        tc_off=tc_off,
        tc_idx=tc_idx,
        tc_lp=tc_lp,
        vcf_head=np.frombuffer(gi.vcf_head.encode("utf-8"), np.uint8),
        vcf_info=np.frombuffer(vcf_info_blob, np.uint8),
        node_chrom=np.array(node_chrom, np.int32),
        node_start=np.array(node_start, np.int64),
        node_nseq=np.array(node_nseq, np.int32),
        node_ngt=np.array(node_ngt, np.int32),
        node_nkmer=np.array(node_nkmer, np.int64),
        seq_lens=np.array(seq_lens, np.int64),
        seq_blob=np.frombuffer(b"".join(seq_parts), np.uint8),
        gt_flat=gt_flat,
        kmer_flat=kmer_flat,
        local_bits=local_bits_arr,
        tbl_keys=gi.table.keys_np(),
        tbl_freq=gi.table.freq_np(),
        tbl_bits=gi.table.hap_words_np(),
        tbl_refflag=gi.table.refflag_np(),
    )
    fh.close()
    log(f"graph write complete ({time.perf_counter() - _t0:.2f}s)",
        func="save_graph")


def load_graph(path: str, device: torch.device | str = "cpu",
               threads: int = 1) -> GraphIndex:
    """A .vgt or, for any file that is not a zip, the reference binary's
    graph.bin, whose local haplotype bits are rebuilt on ``device`` with
    ``threads`` processes walking the contexts."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":
        from .interop import load_reference_graph_bin

        return load_reference_graph_bin(path, device, threads)

    log(f"Genome Graph index loaded from file: {path}")
    with np.load(path, allow_pickle=False) as npz:
        z = {name: npz[name] for name in npz.files}
    meta = json.loads(bytes(z["meta"]).decode("utf-8"))
    if meta.get("magic") != _MAGIC:
        raise ValueError(f"'{path}' is not a varigraph-tpu graph file")

    chroms: list[str] = meta["chroms"]
    hap_names: list[str] = meta["hap_names"]
    nhap = len(hap_names)
    nbytes = (nhap + 7) // 8

    vcf_head = bytes(z["vcf_head"]).decode("utf-8")
    vcf_info: dict[str, dict[int, list[str]]] = {}
    blob = zlib.decompress(bytes(z["vcf_info"])).decode("utf-8")
    if blob:
        for line in blob.split("\n"):
            parts = line.split("\t")
            c, start = parts[0], int(parts[1])
            # compact convention: 9 fixed columns as elements, all remaining
            # fields folded into one tab-joined element
            vcf_info.setdefault(c, {})[start] = (
                parts[2:11] + ["\t".join(parts[11:])]
                if len(parts) > 11 else parts[2:]
            )

    graph = GenomeGraph()
    node_chrom = z["node_chrom"]
    node_start = z["node_start"]
    node_nseq = z["node_nseq"]
    node_ngt = z["node_ngt"]
    node_nkmer = z["node_nkmer"]
    seq_lens = z["seq_lens"]
    seq_blob = bytes(z["seq_blob"])
    gt_flat = z["gt_flat"]
    kmer_flat = z["kmer_flat"]
    local_bits_arr = z["local_bits"]

    seq_off = np.concatenate([[0], np.cumsum(seq_lens)])
    gt_off = np.concatenate([[0], np.cumsum(node_ngt)])
    km_off = np.concatenate([[0], np.cumsum(node_nkmer)])
    si = 0
    for i in range(len(node_chrom)):
        chrom = chroms[node_chrom[i]]
        node = graph.get_or_create(chrom, int(node_start[i]))
        for _ in range(int(node_nseq[i])):
            # lazy views into the shared blob: the genotype phase only reads
            # sequence LENGTHS, so no per-node str is materialized
            node.seqs.append(
                RefSpan(seq_blob, int(seq_off[si]), int(seq_off[si + 1]))
            )
            si += 1
        node.hap_gt = gt_flat[gt_off[i] : gt_off[i + 1]]  # finalize re-homes
        node.kmer_hashes = kmer_flat[km_off[i] : km_off[i + 1]]
        node.local_bits = local_bits_arr[km_off[i] : km_off[i + 1]]
    graph.finalize()

    # precomputed graph2node CSR, if the file carries it
    if "tc_idx" in z:
        tc_off = z["tc_off"]
        tc_idx = z["tc_idx"].astype(np.int64)
        tc_lp = z["tc_lp"]
        pos = ipos = 0
        for ci, chrom in enumerate(chroms):
            n_c = int((node_chrom == ci).sum())
            off = tc_off[pos : pos + n_c + 1]
            pos += n_c + 1
            k_c = int(off[-1]) if len(off) else 0
            graph.tbl_csr[chrom] = (
                off, tc_idx[ipos : ipos + k_c], tc_lp[ipos : ipos + k_c]
            )
            ipos += k_c

    # per-chromosome k-mer CSR straight from the flat layout (nodes are saved
    # grouped by chromosome in finalize()'s order)
    for ci, chrom in enumerate(chroms):
        rows = np.flatnonzero(node_chrom == ci)
        if len(rows):
            lo, hi = int(rows[0]), int(rows[-1]) + 1
            base = km_off[lo]
            graph.kmer_csr[chrom] = (
                (km_off[lo : hi + 1] - base).astype(np.int64),
                kmer_flat[base : km_off[hi]],
                local_bits_arr[base : km_off[hi]],
            )
        else:
            graph.kmer_csr[chrom] = (
                np.zeros(1, np.int64),
                np.empty(0, np.uint64),
                np.zeros((0, nbytes), np.uint8),
            )

    table = KmerTable.from_numpy(
        z["tbl_keys"], None, z["tbl_freq"], z["tbl_bits"], z["tbl_refflag"],
        nhap, device,
    )

    gi = GraphIndex(
        kmer_len=int(meta["kmer_len"]),
        vcf_ploidy=int(meta["vcf_ploidy"]),
        graph_base_num=int(meta["graph_base_num"]),
        genome_size=int(meta["genome_size"]),
        hap_names=hap_names,
        chrom_lens=dict(zip(chroms, meta["chrom_lens"])),
        vcf_head=vcf_head,
        vcf_info=vcf_info,
        graph=graph,
        table=table,
        stats=VariantStats(**meta["stats"]),
    )
    log(f"Total number of bases in the Genome Graph: {gi.graph_base_num}")
    log(f"Total number of k-mers present in the Genome Graph: {table.size}")
    log(f"Total number of haplotypes present in the Genome Graph: {nhap}")
    return gi
