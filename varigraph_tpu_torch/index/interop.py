"""Interop: read and write the reference binary's graph.bin format.

Port of ``varigraph_tpu/index/interop.py``.  The little-endian layout of the
reference's ConstructIndex::save_index (src/construct_index.cpp:760-902) and
load_index (:911-1105): header (graphBaseNum u64, kmerLen u32, vcfPloidy
u32), VCF head + per-site column mirror with chromosome lengths, haplotype
registry, graph nodes (allele sequences, per-haplotype GTs, k-mer hashes), a
u64 ReadBase placeholder, then (kmerHash u64, c u8, f u8, bitVecLen u64,
bits...) records to EOF.

So a graph the reference binary built can be genotyped by the port, and a
graph the port built by the reference binary.  The format carries no
per-node local haplotype bitmasks: on load they are rebuilt by walking and
sketching every haplotype context on the run's device (the computation the
reference defers to genotype time, src/genotype.cpp:725-812).  The files the
port writes are byte-identical to the JAX package's.
"""

from __future__ import annotations

import io
import struct
import sys

import numpy as np
import torch

from ..ops.table import KmerTable
from ..utils.log import log
from .graph import GenomeGraph, VariantStats
from .structs import GraphIndex


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self):
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.data, self.pos)
        self.pos += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def bytes_(self, n):
        if self.pos + n > len(self.data):
            raise IndexError(f"{n} bytes wanted at {self.pos} of {len(self.data)}")
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def str_(self, n):
        return self.bytes_(n).decode("utf-8")

    def eof(self):
        return self.pos >= len(self.data)


def _record_dtype(blen: int) -> np.dtype:
    return np.dtype([("kh", "<u8"), ("c", "u1"), ("f", "u1"), ("blen", "<u8"),
                     ("bits", "u1", (blen,))], align=False)


def _read_records(r: _Reader, nbytes: int):
    """The k-mer records from r's position to EOF: (keys u64, c u8, f u8,
    ref flag bool, hap bits [M, nbytes] u8).  The ref flag rides in bit 7 of
    a record's last byte; it is stripped so only haplotype bits remain.

    Every writer gives all records one bitVecLen, so the records are read as
    one structured array; a file whose lengths vary is read record by
    record."""
    rest = len(r.data) - r.pos
    if rest >= 18:
        (blen,) = struct.unpack_from("<Q", r.data, r.pos + 10)
        dt = _record_dtype(blen)
        if blen and rest % dt.itemsize == 0:
            rec = np.frombuffer(r.data, dt, rest // dt.itemsize, r.pos)
            if (rec["blen"] == blen).all():
                r.pos = len(r.data)
                bits = rec["bits"]
                flags = (bits[:, -1] >> 7).astype(bool)
                rows = np.zeros((len(rec), nbytes), np.uint8)
                take = min(blen, nbytes)
                rows[:, :take] = bits[:, :take]
                if take == blen:
                    rows[:, blen - 1] &= 0x7F
                return (rec["kh"].astype(np.uint64), rec["c"].copy(),
                        rec["f"].copy(), flags, rows)
    keys, covs, freqs, flags, rows = [], [], [], [], []
    while not r.eof():
        keys.append(r.u64())
        covs.append(r.u8())
        freqs.append(r.u8())
        blen = r.u64()
        bits = np.frombuffer(r.bytes_(blen), dtype=np.uint8).copy()
        flags.append(bool(bits[-1] >> 7) if blen else False)
        if blen:
            bits[-1] &= 0x7F
        row = np.zeros(nbytes, np.uint8)
        row[: min(blen, nbytes)] = bits[:nbytes]
        rows.append(row)
    return (np.array(keys, np.uint64), np.array(covs, np.uint8),
            np.array(freqs, np.uint8), np.array(flags, bool),
            np.stack(rows) if rows else np.zeros((0, nbytes), np.uint8))


def load_reference_graph_bin(path: str, device: torch.device | str = "cpu",
                             threads: int = 1) -> GraphIndex:
    """Read a graph.bin; the table's keys and coverage go to ``device``,
    where the local haplotype bits are rebuilt (``rebuild_local_bits``;
    ``threads`` processes walk the contexts)."""
    log(f"Reference-format Genome Graph index loaded from file: {path}")
    with open(path, "rb") as fh:
        r = _Reader(fh.read())
    try:
        gi = _parse(r, device)
    except (struct.error, IndexError, UnicodeDecodeError, KeyError) as e:
        raise ValueError(f"'{path}' is neither a .vgt (zip) nor a complete "
                         f"reference graph.bin ({type(e).__name__}: {e})") from e
    rebuild_local_bits(gi, device, threads)
    log(f"Total number of bases in the Genome Graph: {gi.graph_base_num}")
    log(f"Total number of k-mers present in the Genome Graph: {gi.table.size}")
    log(f"Total number of haplotypes present in the Genome Graph: {gi.nhap}")
    return gi


def _parse(r: _Reader, device) -> GraphIndex:
    """Everything of a graph.bin but the local haplotype bits."""
    graph_base_num = r.u64()
    kmer_len = r.u32()
    vcf_ploidy = r.u32()

    # ---- VCF head + vcfInfoMap (with chromosome lengths) ----
    vcf_head = r.str_(r.u32())
    vcf_info: dict[str, dict[int, list[str]]] = {}
    chrom_lens: dict[str, int] = {}
    n_chr = r.u32()
    for _ in range(n_chr):
        chrom = r.str_(r.u32())
        chrom_lens[chrom] = r.u32()
        nstart = r.u32()
        smap: dict[int, list[str]] = {}
        for _ in range(nstart):
            start = r.u32()
            ninfo = r.u32()
            cols = [r.str_(r.u32()) for _ in range(ninfo)]
            # compact mirror convention (index/graph.py): fold everything
            # past the 9 fixed columns into one tab-joined element
            smap[start] = (cols[:9] + ["\t".join(cols[9:])]
                           if len(cols) > 9 else cols)
        vcf_info[chrom] = smap

    # ---- haplotype registry ----
    hap_num = r.u16()
    hap_names_map: dict[int, str] = {}
    for _ in range(hap_num):
        idx = r.u16()
        hap_names_map[idx] = r.str_(r.u32())
    hap_names = [hap_names_map[i] for i in range(hap_num)]

    # ---- graph nodes ----
    graph = GenomeGraph()
    n_graph_chr = r.u32()
    for _ in range(n_graph_chr):
        chrom = r.str_(r.u32())
        n_nodes = r.u32()
        for _ in range(n_nodes):
            start = r.u32()
            node = graph.get_or_create(chrom, start)
            n_seq = r.u32()
            for _ in range(n_seq):
                node.seqs.append(r.str_(r.u32()))
            n_gt = r.u32()
            node.hap_gt = list(
                np.frombuffer(r.bytes_(2 * n_gt), dtype="<u2").astype(int)
            )
            n_km = r.u32()
            node.kmer_hashes = np.frombuffer(
                r.bytes_(8 * n_km), dtype="<u8"
            ).astype(np.uint64)
            node.local_bits = []
    graph.finalize()

    # ---- global k-mer table ----
    r.u64()  # ReadBase placeholder (construct_index.cpp:877-878)
    keys, covs, freqs, flags, rows = _read_records(r, (hap_num + 7) // 8)
    table = KmerTable.build_packed(keys, freqs, rows, flags, hap_num, device)
    # keep any stored coverage (zero after construct), in the table's
    # unsigned key order (a stable sort of the host uint64 keys)
    if covs.any():
        order = np.argsort(keys, kind="stable")
        table.cov.copy_(torch.from_numpy(covs[order].astype(np.int32)))

    return GraphIndex(
        kmer_len=kmer_len,
        vcf_ploidy=vcf_ploidy,
        graph_base_num=graph_base_num,
        genome_size=sum(chrom_lens.values()),
        hap_names=hap_names,
        chrom_lens=chrom_lens,
        vcf_head=vcf_head,
        vcf_info=vcf_info,
        graph=graph,
        table=table,
        stats=VariantStats(),
    )


def save_reference_graph_bin(gi: GraphIndex, path: str) -> None:
    """Write ``gi`` in the reference binary's graph.bin layout
    (ConstructIndex::save_index, src/construct_index.cpp:760-902), so the
    reference binary can genotype from a graph built by the port.

    Iteration orders mirror the C++ std::map semantics: chromosomes
    lexicographic, node starts / VCF starts / haplotype indices ascending.
    The k-mer records' order is free (the reference loads them into an
    unordered_map, :1060-1101); they are written in sorted-key order.
    BitVec length is (hapNum >> 3) + 1 with bit 7 of the last byte carrying
    the genome-wide ref flag (src/construct_index.cpp:1206-1215)."""
    log(f"Reference-format Genome Graph index saved to file: {path}")
    # a buffered stream straight to the file: the node section is about the
    # whole genome of allele text
    with open(path, "wb") as fh_out:
        w = io.BufferedWriter(fh_out, buffer_size=4 << 20)
        w.write(struct.pack("<QII", gi.graph_base_num, gi.kmer_len,
                            gi.vcf_ploidy))

        # ---- VCF head + vcfInfoMap (with chromosome lengths) ----
        head = gi.vcf_head.encode("utf-8")
        w.write(struct.pack("<I", len(head)))
        w.write(head)
        w.write(struct.pack("<I", len(gi.vcf_info)))
        for chrom in sorted(gi.vcf_info.keys()):
            cb = chrom.encode("utf-8")
            w.write(struct.pack("<I", len(cb)))
            w.write(cb)
            w.write(struct.pack("<I", gi.chrom_lens[chrom]))
            smap = gi.vcf_info[chrom]
            w.write(struct.pack("<I", len(smap)))
            for start in sorted(smap.keys()):
                # expand the compact mirror (per-sample columns tab-joined
                # into one element) back to one string per column
                infos = []
                for e in smap[start]:
                    infos.extend(e.split("\t")) if e else infos.append(e)
                w.write(struct.pack("<II", start, len(infos)))
                for info in infos:
                    ib = info.encode("utf-8")
                    w.write(struct.pack("<I", len(ib)))
                    w.write(ib)

        # ---- haplotype registry ----
        w.write(struct.pack("<H", gi.nhap))
        for idx, name in enumerate(gi.hap_names):
            nb = name.encode("utf-8")
            w.write(struct.pack("<HI", idx, len(nb)))
            w.write(nb)

        # ---- graph nodes ----
        w.write(struct.pack("<I", len(gi.graph.nodes)))
        for chrom in sorted(gi.graph.nodes.keys()):
            cb = chrom.encode("utf-8")
            w.write(struct.pack("<I", len(cb)))
            w.write(cb)
            nodes = gi.graph.nodes[chrom]
            w.write(struct.pack("<I", len(nodes)))
            for node in nodes:
                w.write(struct.pack("<II", node.start, len(node.seqs)))
                for seq in node.seqs:
                    sb = seq.encode("utf-8")
                    w.write(struct.pack("<I", len(sb)))
                    w.write(sb)
                w.write(struct.pack("<I", len(node.hap_gt)))
                w.write(np.asarray(node.hap_gt, dtype="<u2").tobytes())
                w.write(struct.pack("<I", len(node.kmer_hashes)))
                w.write(np.asarray(node.kmer_hashes, dtype="<u8").tobytes())

        # ---- global k-mer table ----
        w.write(struct.pack("<Q", 0))  # ReadBase placeholder (:877-878)
        blen = (gi.nhap >> 3) + 1
        nbytes = (gi.nhap + 7) // 8
        rec = np.zeros(gi.table.size, dtype=_record_dtype(blen))
        rec["kh"] = gi.table.keys_np()
        rec["c"] = gi.table.cov_u8()
        rec["f"] = gi.table.freq_np()
        rec["blen"] = blen
        hap_bytes = _words_to_bytes(gi.table.hap_words_np())
        take = min(nbytes, hap_bytes.shape[1], blen)
        rec["bits"][:, :take] = hap_bytes[:, :take]
        rec["bits"][:, blen - 1] |= gi.table.refflag_np().astype(np.uint8) << 7
        w.flush()
        w.detach()  # the records go straight to fh_out, which `with` closes
        rec.tofile(fh_out)


def _words_to_bytes(words: np.ndarray) -> np.ndarray:
    """[M, W] uint32 -> [M, W*4] little-endian bytes."""
    if sys.byteorder == "little":
        return np.ascontiguousarray(words).view(np.uint8)
    m, w_ = words.shape
    out = np.zeros((m, w_ * 4), np.uint8)
    for j in range(4):
        out[:, j::4] = ((words >> np.uint32(8 * j)) & np.uint32(0xFF)).astype(
            np.uint8
        )
    return out


def rebuild_local_bits(gi: GraphIndex, device: torch.device | str = "cpu",
                       threads: int = 1) -> None:
    """Rebuild every variant node's local haplotype bitmask: bit h of a
    k-mer's row is set when haplotype h's context at the node holds it (the
    computation the reference performs during genotyping,
    src/genotype.cpp:725-812).

    The JAX function walks every (node, haplotype) context.  Here the
    construct path's walk (build.collect_contexts) walks each distinct
    context once and hands back the haplotypes that share it, so its bits
    are the same; the distinct contexts are sketched on ``device``."""
    from .build import _sketch_contexts, collect_contexts

    k = gi.kmer_len
    nbytes = (gi.nhap + 7) // 8
    tasks = [(chrom, i, node)
             for chrom in sorted(gi.graph.nodes.keys())
             for i, node in enumerate(gi.graph.nodes[chrom])
             if node.is_variant and len(node.kmer_hashes)]
    for chrom in gi.graph.nodes:
        for node in gi.graph.nodes[chrom]:
            if node.is_variant:
                node.local_bits = np.zeros((len(node.kmer_hashes), nbytes),
                                           np.uint8)
    _, contexts, groups = collect_contexts(gi.graph, k, gi.vcf_ploidy, False,
                                           threads=threads, tasks=tasks)
    g_task, g_cid, g_bits, _, _ = groups
    ctx_kmers = _sketch_contexts(contexts, k, device)
    for t, cid, bits in zip(g_task, g_cid, g_bits):
        node = tasks[t][2]
        present = np.isin(node.kmer_hashes, ctx_kmers[cid])
        w = min(nbytes, len(bits))
        node.local_bits[present, :w] |= bits[:w]
