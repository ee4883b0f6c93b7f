"""Wrappers of the window prep's CUDA kernels (``csrc/prep.cu``).

``hap_mass_(out, nodes, tables, cov)``: out int64 [G, nhap], overwritten
with each window's k-mer mass a haplotype over its nodes' rows (those with
c = min(cov, 255) > 1 and f == 1; genotype.cpp:536-572); nodes int64 [G, Nn],
window g's node ids into ``tables.off`` and then -1.

``gather_rows_(c, f, flag, kmask, bits, local, kind, nodes, top, used,
tables, cov)``: each node row (g, n) of the group, ``nodes[g, n]`` (-1 for
a pad row), keeps its rows whose hap words meet ``top[g]`` (int32 [G, Wt],
the window's top haplotypes as the table's words), in CSR order, and writes
them where the emissions (``ops/emit.py``) and the posterior
(``ops/post.py``) read them: c, f uint8 and flag, kmask bool [G, N, K]; bits
and local int32 [G, N, K, Ww], bit j of word j // 32 the table's and the
node-local bit of hap ``used[g, j]`` (int32 [G, 32 Ww], -1 none); kind
int32 [G, N]: 1, 2 where the node keeps no row, 0 for a pad row.  Slots past
the kept rows read 0; K <= 128, the CSR's cap a node.

``tables`` is a ``ops/prep.PrepTables`` and cov the table's int32 coverage,
both on the outputs' device.  Neither kernel replaces a TPU or XLA kernel:
the JAX engine's window prep is host numpy
(``varigraph_tpu/genotype/engine_jax.py:297``).  Both are bound by bytes
(the rows' indices, local bytes and table entries, and the gather's K (4 +
8 Ww) bytes a node row); ``csrc/prep.cu`` describes their design.

On CPU tensors they run the plain versions, ``ops/prep.hap_mass_plain`` and
``gather_rows_plain`` (the engine's numpy lines).  On CUDA tensors they
launch the kernel or raise: a failed build or launch is an error, never a
quiet fall back to plain code.  A launch runs on the tensors' device and its
current stream and does not wait for the card.  ``LAUNCHES["hap_mass"]`` and
``LAUNCHES["gather_rows"]`` count the launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary
from .prep import PrepTables, gather_rows_plain, hap_mass_plain

MAX_KMERS = 128
# hap_mass's per-hap sums in shared memory: 32 Wt x 8 bytes <= 48 KB
MAX_HAP_WORDS = 192


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_hap_mass.restype = i
    lib.vg_hap_mass.argtypes = [p] * 7 + [n, n, i, i, p]
    lib.vg_gather_rows.restype = i
    lib.vg_gather_rows.argtypes = [p] * 17 + [n, n, i, i, i, i, p]


_LIB = KernelLibrary("prep.cu", "libvgprep.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the prep library; raises RuntimeError
    when nvcc fails."""
    return _LIB.load()


def _check(args, device) -> None:
    for name, t, dtype, shape in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the outputs on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the prep's kernels run on cpu or cuda, not {device}")


def _table_args(tables: PrepTables, cov: torch.Tensor) -> list:
    if not isinstance(tables, PrepTables):
        raise TypeError("tables must be a PrepTables")
    M, Wt = tables.hapbits.shape
    if not 1 <= Wt <= MAX_HAP_WORDS or tables.nhap > 32 * Wt:
        raise ValueError(f"the table's hap words must hold its {tables.nhap} "
                         f"haplotypes in 1..{MAX_HAP_WORDS} words, got {Wt}")
    R = tables.idx.shape[0]
    return [("off", tables.off, torch.int64, None),
            ("idx", tables.idx, torch.int32, (R,)),
            ("lp", tables.lp, torch.uint8, (R, (tables.nhap + 7) // 8)),
            ("cov", cov, torch.int32, (M,)),
            ("freq", tables.freq, torch.uint8, (M,)),
            ("hapbits", tables.hapbits, torch.int32, (M, Wt)),
            ("refflag", tables.refflag, torch.bool, (M,))]


def hap_mass_(out: torch.Tensor, nodes: torch.Tensor, tables: PrepTables,
              cov: torch.Tensor) -> None:
    """out[g, h] = window g's k-mer mass of haplotype h (see the module
    docstring), in place."""
    if not isinstance(out, torch.Tensor) or out.dim() != 2:
        raise ValueError("out must be a 2-D torch.Tensor [G, nhap]")
    if not isinstance(nodes, torch.Tensor) or nodes.dim() != 2:
        raise ValueError("nodes must be a 2-D torch.Tensor [G, Nn]")
    G, nhap = out.shape
    if nhap != tables.nhap:
        raise ValueError(f"out must hold the table's {tables.nhap} haplotypes, "
                         f"got {nhap}")
    _check([("out", out, torch.int64, None),
            ("nodes", nodes, torch.int64, (G, nodes.shape[1])),
            *_table_args(tables, cov)], out.device)
    if out.device.type == "cpu":
        hap_mass_plain(out, nodes, tables, cov)
        return
    out.zero_()
    if nodes.numel() == 0:
        return
    lib = build()
    dev = out.device
    with torch.cuda.device(dev):
        rc = lib.vg_hap_mass(
            nodes.data_ptr(), tables.off.data_ptr(), tables.idx.data_ptr(),
            cov.data_ptr(), tables.freq.data_ptr(), tables.hapbits.data_ptr(),
            out.data_ptr(), G, nodes.shape[1], tables.hapbits.shape[1], nhap,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hap_mass kernel launch failed: CUDA error {rc}")
    LAUNCHES["hap_mass"] += 1


def gather_rows_(c: torch.Tensor, f: torch.Tensor, flag: torch.Tensor,
                 kmask: torch.Tensor, bits: torch.Tensor, local: torch.Tensor,
                 kind: torch.Tensor, nodes: torch.Tensor, top: torch.Tensor,
                 used: torch.Tensor, tables: PrepTables, cov: torch.Tensor) -> None:
    """Each node row's kept k-mer rows into the group's inputs (see the
    module docstring), in place."""
    if not isinstance(bits, torch.Tensor) or bits.dim() != 4:
        raise ValueError("bits must be a 4-D torch.Tensor [G, N, K, Ww]")
    G, N, K, Ww = bits.shape
    if not 1 <= K <= MAX_KMERS:
        raise ValueError(f"K must be in 1..{MAX_KMERS}, got {K}")
    Wt = tables.hapbits.shape[1] if isinstance(tables, PrepTables) else 0
    _check([("c", c, torch.uint8, (G, N, K)), ("f", f, torch.uint8, (G, N, K)),
            ("flag", flag, torch.bool, (G, N, K)),
            ("kmask", kmask, torch.bool, (G, N, K)),
            ("bits", bits, torch.int32, (G, N, K, Ww)),
            ("local", local, torch.int32, (G, N, K, Ww)),
            ("kind", kind, torch.int32, (G, N)),
            ("nodes", nodes, torch.int64, (G, N)),
            ("top", top, torch.int32, (G, Wt)),
            ("used", used, torch.int32, (G, 32 * Ww)),
            *_table_args(tables, cov)], bits.device)
    if bits.device.type == "cpu":
        gather_rows_plain(c, f, flag, kmask, bits, local, kind, nodes, top,
                          used, tables, cov)
        return
    if kind.numel() == 0:
        return
    lib = build()
    dev = bits.device
    with torch.cuda.device(dev):
        rc = lib.vg_gather_rows(
            nodes.data_ptr(), top.data_ptr(), used.data_ptr(),
            tables.off.data_ptr(), tables.idx.data_ptr(), tables.lp.data_ptr(),
            cov.data_ptr(), tables.freq.data_ptr(), tables.hapbits.data_ptr(),
            tables.refflag.data_ptr(), c.data_ptr(), f.data_ptr(),
            flag.data_ptr(), kmask.data_ptr(), bits.data_ptr(), local.data_ptr(),
            kind.data_ptr(), G, N, K, Wt, Ww, tables.lp.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES["gather_rows"] += 1
