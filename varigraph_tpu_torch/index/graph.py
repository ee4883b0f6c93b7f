"""Genome-graph data model (host side).

The data-model half of ``varigraph_tpu/index/graph.py``: the node-per-variant
graph that a .vgt file holds (reference ConstructIndex, nodes ordered by start
position per chromosome, reference filler nodes carrying the sequence between
variants).  Building a graph from a VCF (``build_graph_from_vcf``,
``find_node_up_down_seq``) belongs to construct, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.log import log


class RefSpan:
    """Lazy string view of a backing sequence slice [lo, hi).

    Filler nodes carry the whole inter-variant reference sequence as
    seqs[0]; storing it as a str would duplicate ~the entire genome on top
    of fasta_map (~1 GB of extra RSS at 1 Gbp, ~3 GB at human scale).  A
    RefSpan keeps (backing, lo, hi) -- the backing is a chromosome str at
    construct time or the mmap-able seq blob bytes at load time -- and
    materializes only the small slices the graph walker actually reads
    (typically <= k-1 bases per visit).

    Implements exactly the str operations the walker
    (find_node_up_down_seq), serializers, and engines use: len/bool,
    indexing/slicing, str(), +/radd, ==, hash, encode, upper.
    INTENTIONALLY UNSUPPORTED (raise AttributeError): startswith, count,
    replace, find, split, iteration protocols beyond __getitem__.  Note
    `in`/`for` fall back to per-char __getitem__ (correct but quadratic)
    and ==/hash materialize the whole slice -- if a new consumer needs
    those on genome-scale fillers, add a dedicated method instead."""

    __slots__ = ("_b", "_lo", "_hi")

    def __init__(self, backing, lo: int, hi: int):
        self._b = backing
        self._lo = lo
        self._hi = max(lo, hi)

    def __len__(self) -> int:
        return self._hi - self._lo

    def __bool__(self) -> bool:
        return self._hi > self._lo

    def _materialize(self, lo: int, hi: int) -> str:
        piece = self._b[lo:hi]
        return piece if isinstance(piece, str) else piece.decode("ascii")

    def __str__(self) -> str:
        return self._materialize(self._lo, self._hi)

    def __getitem__(self, idx) -> str:
        n = self._hi - self._lo
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(n)
            if step != 1:
                return self._materialize(self._lo, self._hi)[idx]
            return self._materialize(self._lo + lo, self._lo + hi)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        return self._materialize(self._lo + idx, self._lo + idx + 1)

    def __add__(self, other) -> str:
        return str(self) + str(other)

    def __radd__(self, other) -> str:
        return str(other) + str(self)

    def __eq__(self, other) -> bool:
        if isinstance(other, (str, RefSpan)):
            return len(self) == len(other) and str(self) == str(other)
        return NotImplemented

    def __hash__(self):
        return hash(str(self))

    def __repr__(self) -> str:
        return f"RefSpan({len(self)} bases)"

    def encode(self, encoding: str = "ascii") -> bytes:
        b = self._b[self._lo:self._hi]
        return b.encode(encoding) if isinstance(b, str) else bytes(b)

    def upper(self) -> str:
        return str(self).upper()


@dataclass
class Node:
    """One graph node (reference nodeSrt, include/construct_index.hpp:105-121).

    seqs[0] is the REF allele (or the filler sequence); hap_gt[h] is the
    allele index haplotype h carries (0 = REF).  Filler nodes have
    hap_gt == [0].  After GenomeGraph.finalize(), hap_gt is a numpy uint16
    row view into the per-chromosome GT matrix (same indexing/len semantics;
    ~15x less host RAM than Python int lists at genome scale).
    """
    start: int  # 1-based
    seqs: list[str] = field(default_factory=list)
    hap_gt: object = field(default_factory=list)
    # filled by the indexing phase:
    kmer_hashes: list[int] = field(default_factory=list)  # encoded k-mers
    # per-kmer haplotype-presence bitmask, packed uint8 [n_kmers, ceil(H/8)]
    local_bits: object = field(default_factory=list)

    @property
    def is_variant(self) -> bool:
        return len(self.hap_gt) > 1

    @property
    def end(self) -> int:
        return self.start + len(self.seqs[0]) - 1


class GenomeGraph:
    """Per-chromosome ordered node collections.

    finalize() additionally builds per-chromosome numpy views of the node
    metadata the genotype engine gathers per window (starts, ends, GT
    matrix): the per-node Python loops over these were ~30% of scoring time
    at the 100 Mb scale and linear in node count (VERDICT r2 item 4).
    """

    def __init__(self):
        self._maps: dict[str, dict[int, Node]] = {}
        self.starts: dict[str, list[int]] = {}
        self.nodes: dict[str, list[Node]] = {}
        # per-chromosome dense metadata (built by finalize)
        self.starts_np: dict[str, np.ndarray] = {}
        self.ends_np: dict[str, np.ndarray] = {}
        self.gt_mat: dict[str, np.ndarray] = {}   # [n, width] u16, 0-padded
        self.gt_len: dict[str, np.ndarray] = {}   # [n] int32
        # per-chromosome CSR of node k-mer data: raw hashes as produced by
        # indexing (kmer_csr) and table-resolved <=128-per-node slices
        # (tbl_csr, built by genotype.engine_np.graph2node).  Node attributes
        # (kmer_hashes / local_bits / table_idx / local_packed) are views
        # into these flats; the engines gather windows by slicing offsets
        # instead of concatenating per-node Python lists (VERDICT r2 item 4).
        self.kmer_csr: dict[str, tuple] = {}   # (off[n+1], kh u64, lb u8[.,B])
        self.tbl_csr: dict[str, tuple] = {}    # (off[n+1], idx i64, lp u8[.,B])

    def get_or_create(self, chrom: str, start: int) -> Node:
        chrom_map = self._maps.setdefault(chrom, {})
        node = chrom_map.get(start)
        if node is None:
            node = Node(start=start)
            chrom_map[start] = node
        return node

    def finalize(self) -> None:
        """Sort nodes by start per chromosome (std::map iteration order) and
        densify node metadata.  Each node's hap_gt becomes a row view into
        gt_mat (zero-padded: a missing haplotype's GT reads as 0 = REF,
        matching the engines' out-of-range default)."""
        self.starts = {}
        self.nodes = {}
        for chrom, cmap in self._maps.items():
            items = sorted(cmap.items())
            self.starts[chrom] = [s for s, _ in items]
            self.nodes[chrom] = [n for _, n in items]
            nodes = self.nodes[chrom]
            n = len(nodes)
            lens = np.fromiter((len(nd.hap_gt) for nd in nodes), np.int32, n)
            width = int(lens.max()) if n else 0
            mat = np.zeros((n, width), np.uint16)
            for i, nd in enumerate(nodes):
                li = lens[i]
                if li:
                    mat[i, :li] = nd.hap_gt
                nd.hap_gt = mat[i, :li]
            self.gt_mat[chrom] = mat
            self.gt_len[chrom] = lens
            self.starts_np[chrom] = np.fromiter(
                (nd.start for nd in nodes), np.int64, n
            )
            self.ends_np[chrom] = self.starts_np[chrom] + np.fromiter(
                (len(nd.seqs[0]) for nd in nodes), np.int64, n
            ) - 1

    def build_kmer_csr(self, nbytes: int) -> None:
        """Collect each node's kmer_hashes/local_bits into one flat array
        per chromosome and re-home the node attributes as views into it.
        Callers that already hold the flat layout (serialize.load_graph)
        fill self.kmer_csr directly instead."""
        for chrom, nodes in self.nodes.items():
            n = len(nodes)
            lens = np.fromiter(
                (len(nd.kmer_hashes) for nd in nodes), np.int64, n
            )
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            if off[-1]:
                kh = np.concatenate(
                    [np.asarray(nd.kmer_hashes, np.uint64)
                     for nd, li in zip(nodes, lens) if li]
                )
                lb = np.concatenate(
                    [np.asarray(nd.local_bits, np.uint8).reshape(li, -1)
                     for nd, li in zip(nodes, lens) if li]
                )
            else:
                kh = np.empty(0, np.uint64)
                lb = np.zeros((0, nbytes), np.uint8)
            self.kmer_csr[chrom] = (off, kh, lb)
            for i, nd in enumerate(nodes):
                nd.kmer_hashes = kh[off[i]:off[i + 1]]
                nd.local_bits = lb[off[i]:off[i + 1]]

    def gt_submatrix(self, chrom: str, node_idx: np.ndarray,
                     haps) -> np.ndarray:
        """[len(node_idx), len(haps)] int64 GT gather with 0 (REF) for
        haplotypes beyond a node's GT vector."""
        mat = self.gt_mat[chrom]
        uh = np.asarray(haps, np.int64)
        out = np.zeros((len(node_idx), len(uh)), np.int64)
        valid = uh < mat.shape[1]
        if valid.any() and len(node_idx):
            out[:, valid] = mat[np.ix_(node_idx, uh[valid])]
        return out

    @property
    def chroms(self) -> list[str]:
        return sorted(self.nodes.keys())


def gt_split(gt_txt: str) -> list[str]:
    """Split a GT field (reference construct_index.cpp:1616-1643)."""
    if gt_txt == ".":
        return []
    if "/" in gt_txt:
        return gt_txt.split("/")
    if "|" in gt_txt:
        return gt_txt.split("|")
    try:
        int(gt_txt)
    except ValueError:
        raise ValueError(f"GT is not separated by '/' or '|' -> {gt_txt}")
    log(f"Warning: sample has only one genotype, attempting to correct to diploid -> {gt_txt}")
    return [gt_txt]


@dataclass
class VariantStats:
    snp: int = 0
    indel: int = 0
    ins: int = 0
    dele: int = 0
    inv: int = 0
    dup: int = 0
    other: int = 0

    def total(self) -> int:
        return self.snp + self.indel + self.ins + self.dele + self.inv + self.dup + self.other
