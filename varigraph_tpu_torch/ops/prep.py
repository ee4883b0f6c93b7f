"""The genotyping window prep's per-k-mer pass: the plain numpy versions,
with the kernels' contracts, and the device copies the kernels read.

A window's prep (``genotype/engine_torch._WindowPrep``) walks its nodes'
rows of the graph's CSR over the k-mer table (``graph.tbl_csr[chrom]``:
``off`` [n + 1], ``idx`` each row's table index, ``lp`` [rows, ceil(nhap /
8)] uint8, each row's node-local hap bits, hap h at bit h % 8 of byte h //
8) twice:

  * the haplotype selection's k-mer mass (genotype.cpp:536-572): each row of
    the window's variant nodes whose k-mer has c = min(cov, 255) > 1 and
    f == 1 adds c to every haplotype whose bit it carries
    (``hapselect.window_hap_counts``);
  * the gather (``window_rows``): each scored node's rows whose hap bits meet
    the window's top haplotypes, in CSR order (at most K a node), with their
    c, f, ref flag and the used haplotypes' table and local bits.

The engine calls ``ops/prep_cuda.hap_mass_`` and ``gather_rows_`` on
``PrepTables``, copies of the table's arrays and of every chromosome's CSR
in one on the table's device.  On the card they run the kernels
``csrc/prep.cu``; on CPU tensors their plain versions here,
``hap_mass_plain`` and ``gather_rows_plain``, with the same contract (the
module docstring of ``ops/prep_cuda.py``), through which the tests hold the
kernels to these lines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .post import unpack_words
from .table import pack_hapbits, unpack_hapbits


def node_rows(off: np.ndarray, node_idx: np.ndarray) -> np.ndarray:
    """Flat row indices of the CSR segments for the given nodes, in node
    order: concat(arange(off[i], off[i+1]) for i in node_idx), vectorized."""
    lens = off[node_idx + 1] - off[node_idx]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum0 = np.zeros(len(node_idx), np.int64)
    np.cumsum(lens[:-1], out=cum0[1:])
    return np.repeat(off[node_idx] - cum0, lens) + np.arange(total, dtype=np.int64)


def window_rows(off, idx, lp, cand, top_hap, used_haps, cov_u8, freq_np,
                hap_words, refflag, nhap: int, K: int):
    """One window's gather (the JAX engine's ``_WindowPrep`` lines): for its scored nodes ``cand`` (rows
    of ``off``), (c, f [n, K] int32, flag, kmask [n, K] bool, bits_u,
    local_u [n, K, len(used_haps)] uint8 0/1, kind [n] int32).  A node keeps
    its rows whose hap bits meet ``top_hap``, in CSR order; kind is 2 where
    it keeps none."""
    n = len(cand)
    U = len(used_haps)
    c = np.zeros((n, K), np.int32)
    f = np.zeros((n, K), np.int32)
    flag = np.zeros((n, K), bool)
    kmask = np.zeros((n, K), bool)
    bits_u = np.zeros((n, K, U), np.uint8)
    local_u = np.zeros((n, K, U), np.uint8)
    kind = np.ones(n, np.int32)
    lens = off[cand + 1] - off[cand]
    if lens.sum() > 0:
        flat_rows = node_rows(off, cand)
        flat_idx = idx[flat_rows]
        node_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        all_local = lp[flat_rows]
        rows_flat = unpack_hapbits(hap_words[flat_idx], nhap)
        keep_flat = rows_flat[:, top_hap].any(axis=1)
        act_flat = flat_idx[keep_flat]
        act_node = node_of[keep_flat]
        counts = np.bincount(act_node, minlength=n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        pos = np.arange(len(act_flat), dtype=np.int64) - offs[act_node]
        kind[counts == 0] = 2
        c[act_node, pos] = cov_u8[act_flat]
        f[act_node, pos] = freq_np[act_flat]
        flag[act_node, pos] = refflag[act_flat]
        kmask[act_node, pos] = True
        bits_u[act_node, pos] = rows_flat[keep_flat][:, used_haps]
        unpacked = np.unpackbits(all_local[keep_flat], axis=1, bitorder="little")
        local_u[act_node, pos] = unpacked[:, used_haps]
    else:
        kind[:] = 2
    return c, f, flag, kmask, bits_u, local_u, kind


def pack_rows(a: np.ndarray) -> np.ndarray:
    """[n, K, U] 0/1 -> [n, K, ceil(U / 32)] uint32 words, as the group's
    inputs hold a window's bits and local bits (hap u at bit u % 32 of word
    u // 32)."""
    n, K, _ = a.shape
    return pack_hapbits(a.reshape(n * K, -1)).reshape(n, K, -1)


@dataclass
class PrepTables:
    """The k-mer table's arrays and the graph's CSR on one device, as the
    prep reads them: every chromosome's CSR in one, a chromosome's node i at
    ``base[chrom] + i``.  Made once a graph index (``upload``); cov is read
    from the table at each call, as counting writes it in place."""

    freq: torch.Tensor       # uint8 [M]
    hapbits: torch.Tensor    # int32 [M, Wt], the table's uint32 words
    refflag: torch.Tensor    # bool [M]
    off: torch.Tensor        # int64 [nodes + 1]
    idx: torch.Tensor        # int32 [R]
    lp: torch.Tensor         # uint8 [R, ceil(nhap / 8)]
    base: dict               # chromosome -> its first node in off
    nhap: int

    @staticmethod
    def upload(table, tbl_csr: dict, device=None) -> "PrepTables":
        """Copies ``table``'s freq, hap words and ref flag and each
        chromosome's (off, idx, lp) of ``tbl_csr`` to ``device`` (default:
        the table's; on the CPU the table's arrays are shared, not copied).
        The rows go in a chromosome at a time, into tensors allocated once;
        no host array of the whole CSR is made."""
        dev = torch.device(device) if device is not None else table.device
        if table.size >= 1 << 31:
            raise ValueError(f"the prep's kernels index fewer than 2^31 keys, "
                             f"got {table.size}")
        chroms = sorted(tbl_csr)
        n_nodes = sum(len(tbl_csr[c][0]) - 1 for c in chroms)
        n_rows = sum(int(tbl_csr[c][0][-1] - tbl_csr[c][0][0]) for c in chroms)
        nb = (table.nhap + 7) // 8
        off = np.empty(n_nodes + 1, np.int64)
        idx = torch.empty(n_rows, dtype=torch.int32, device=dev)
        lp = torch.empty((n_rows, nb), dtype=torch.uint8, device=dev)
        base, node, row = {}, 0, 0
        for chrom in chroms:
            o, i, b = tbl_csr[chrom]
            n, k = len(o) - 1, int(o[-1] - o[0])
            base[chrom] = node
            off[node:node + n] = o[:-1] - o[0] + row
            idx[row:row + k].copy_(torch.from_numpy(
                np.asarray(i[o[0]:o[-1]]).astype(np.int32)))
            lp[row:row + k].copy_(torch.from_numpy(
                np.ascontiguousarray(b[o[0]:o[-1], :nb])))
            node, row = node + n, row + k
        off[node] = row
        return PrepTables(
            freq=torch.from_numpy(table.freq).to(dev),
            hapbits=torch.from_numpy(table.hapbits.view(np.int32)).to(dev),
            refflag=torch.from_numpy(table.refflag).to(dev),
            off=torch.from_numpy(off).to(dev), idx=idx, lp=lp, base=base,
            nhap=table.nhap)

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.freq, self.hapbits, self.refflag, self.off, self.idx, self.lp))


def _cov_u8(cov: np.ndarray) -> np.ndarray:
    """cov saturated to uint8, as ``KmerTable.cov_u8`` gives it."""
    return np.minimum(cov, 255).astype(np.uint8)


def hap_mass_plain(out, nodes, tables: PrepTables, cov) -> None:
    """out[g] = the k-mer mass of each haplotype over window g's nodes
    (``nodes[g]``, then -1), through ``hapselect.window_hap_counts`` on the
    window's table entries alone (the engine calls it a window at a time)."""
    from ..genotype.hapselect import window_hap_counts

    off, idx = tables.off.numpy(), tables.idx.numpy()
    words = tables.hapbits.numpy().view(np.uint32)
    o = out.numpy()
    for g, row in enumerate(nodes.numpy()):
        at = idx[node_rows(off, row[row >= 0])]
        o[g] = window_hap_counts([np.arange(len(at))], _cov_u8(cov.numpy()[at]),
                                 tables.freq.numpy()[at], words[at],
                                 out.shape[1]).astype(np.int64)


def gather_rows_plain(c, f, flag, kmask, bits, local, kind, nodes, top, used,
                      tables: PrepTables, cov) -> None:
    """Each window's ``window_rows``, its bits and local bits packed into
    words (``pack_rows``), into the group's outputs (zeros past a window's
    nodes and kept rows)."""
    off, idx, lp = tables.off.numpy(), tables.idx.numpy(), tables.lp.numpy()
    cov_u8, freq, refflag = _cov_u8(cov.numpy()), tables.freq.numpy(), tables.refflag.numpy()
    words = tables.hapbits.numpy().view(np.uint32)
    K = c.shape[2]
    outs = tuple(t.numpy() for t in (c, f, flag, kmask, bits, local, kind))
    for t in outs:
        t[...] = 0
    c_o, f_o, flag_o, kmask_o, bits_o, local_o, kind_o = outs
    for g, (row, tw, uw) in enumerate(zip(nodes.numpy(), top.numpy(),
                                          used.numpy())):
        cand = row[row >= 0]
        n = len(cand)
        if n == 0:
            continue
        top_hap = np.flatnonzero(unpack_words(tw))
        used_haps = uw[uw >= 0]
        cw, fw, flw, kw, bu, lu, kd = window_rows(
            off, idx, lp, cand, top_hap, used_haps, cov_u8, freq, words,
            refflag, tables.nhap, K)
        c_o[g, :n], f_o[g, :n], flag_o[g, :n], kmask_o[g, :n] = cw, fw, flw, kw
        bp, lpk = pack_rows(bu), pack_rows(lu)
        bits_o[g, :n, :, :bp.shape[2]] = bp.view(np.int32)
        local_o[g, :n, :, :lpk.shape[2]] = lpk.view(np.int32)
        kind_o[g, :n] = kd
