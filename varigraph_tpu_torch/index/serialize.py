"""Loading a saved graph (.vgt).

The load side of ``varigraph_tpu/index/serialize.py``: a .vgt is an npz
bundle carrying the header (graph base count, k, vcf ploidy), the VCF head
and per-site column mirror with chromosome lengths, the haplotype registry,
every graph node (allele sequences, per-haplotype GTs, per-node k-mer hashes
and local haplotype bitmasks), the precomputed node -> table CSR, and the
global k-mer table.  The table's keys and coverage go to ``device``; the rest
stays host numpy.

Saving, and reading the reference binary's graph.bin, are not ported yet.
"""

from __future__ import annotations

import json
import zlib

import numpy as np
import torch

from ..ops.table import KmerTable
from ..utils.log import log
from .graph import GenomeGraph, RefSpan, VariantStats
from .structs import GraphIndex

_MAGIC = "varigraph-tpu-graph"


def load_graph(path: str, device: torch.device | str = "cpu") -> GraphIndex:
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":
        raise ValueError(
            f"'{path}' is not a .vgt (zip) graph file; reading the reference "
            "binary's graph.bin is not ported yet (use varigraph_tpu to "
            "convert it)"
        )

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
