"""Wrapper of the CUDA emissions kernel (``csrc/emit.cu``).

``emissions_(out, c, f, flag, kmask, bits, local, gt0, state_u, smask, ave,
lower, upper, log_p, log_q, log_prior)`` writes into ``out`` [G, N, S] the
log-emission of every node row and state of G windows: the contract of
``ops/emit.emissions_plain``, whose module docstring lists the arguments
(the kernel takes at most ``MAX_KMERS`` k-mers a node, the engine's
``MAX_NODE_KMERS``).  It replaces the XLA body ``_emissions_body``
(``varigraph_tpu/genotype/engine_jax.py:70``, vmapped over windows as
``_emissions_group``, ``:174``).

On CPU tensors it runs the plain version, ``ops/emit.emissions_plain``.  On
CUDA tensors it launches the kernel or raises: a failed build or launch is
an error, never a quiet fall back to plain code.  The kernel runs on the
tensors' device and its current stream, and calls no library: the hap words
and launch-wide term tables replace the plain version's contractions.

The call does not wait for the card: its checks read shapes, dtypes,
devices and strides only.  A valid state's slot outside 0..32 W - 1 raises
ValueError on the CPU; on the card the kernel checks each slot as it loads
it and fails a device assert, which the next synchronizing call reports
(and which leaves the process's CUDA context unusable, as PyTorch's own
device-side asserts do).

The kernel is compiled from the repository's source with ``nvcc`` at first
use (``ops/cuda_build.py``), with ``-fmad=false``: its products and sums
round one at a time, as the plain version's torch operations do.
``LAUNCHES["emissions"]`` counts kernel launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary
from .emit import emissions_plain

MAX_PLOIDY = 8
MAX_KMERS = 128     # a node row is one warp's: 32 lanes x 4 k-mers


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i, fl = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_float
    lib.vg_emissions.restype = i
    lib.vg_emissions.argtypes = [p] * 10 + [n, n, i, i, i, i] + [fl] * 6 + [p]


_LIB = KernelLibrary("emit.cu", "libvgemit.so", _declare, flags=("-fmad=false",))
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the emissions library; raises
    RuntimeError when nvcc fails."""
    return _LIB.load()


def _check(out, c, f, flag, kmask, bits, local, gt0, state_u, smask) -> None:
    if not isinstance(out, torch.Tensor) or not isinstance(bits, torch.Tensor):
        raise TypeError("out and bits must be torch.Tensors")
    if out.dim() != 3 or bits.dim() != 4:
        raise ValueError(f"out must be 3-D and bits 4-D, got shapes "
                         f"{tuple(out.shape)} and {tuple(bits.shape)}")
    G, N, S = out.shape
    K, W = bits.shape[2], bits.shape[3]
    if not isinstance(state_u, torch.Tensor) or state_u.dim() != 3:
        raise ValueError("state_u must be a 3-D torch.Tensor [G, S, P]")
    P = state_u.shape[2]
    args = [("out", out, torch.float32, (G, N, S)),
            ("c", c, torch.uint8, (G, N, K)),
            ("f", f, torch.uint8, (G, N, K)),
            ("flag", flag, torch.bool, (G, N, K)),
            ("kmask", kmask, torch.bool, (G, N, K)),
            ("bits", bits, torch.int32, (G, N, K, W)),
            ("local", local, torch.int32, (G, N, K, W)),
            ("gt0", gt0, torch.bool, (G, N, 32 * W)),
            ("state_u", state_u, torch.int32, (G, S, P)),
            ("smask", smask, torch.bool, (G, S))]
    for name, t, dtype, shape in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"emissions_ runs on cpu or cuda, not {out.device}")
    if not 1 <= P <= MAX_PLOIDY:
        raise ValueError(f"P must be in 1..{MAX_PLOIDY}, got {P}")
    if W < 1:
        raise ValueError("bits must hold at least one word a k-mer")
    if out.device.type == "cuda":
        if K > MAX_KMERS:
            raise ValueError(f"the kernel takes at most {MAX_KMERS} k-mers a "
                             f"node, got {K}")
        return   # the kernel checks the slots: no host sync here
    slots = state_u[smask]
    if slots.numel() and bool(((slots < 0) | (slots >= 32 * W)).any()):
        raise ValueError(f"a valid state's slot is outside 0..{32 * W - 1}")


def emissions_(out: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
               flag: torch.Tensor, kmask: torch.Tensor, bits: torch.Tensor,
               local: torch.Tensor, gt0: torch.Tensor, state_u: torch.Tensor,
               smask: torch.Tensor, ave: float, lower: float, upper: float,
               log_p: float, log_q: float, log_prior: float) -> None:
    """out[g, n, s] = the log-emission of node row (g, n) in state s, -inf
    for a masked state, in place."""
    _check(out, c, f, flag, kmask, bits, local, gt0, state_u, smask)
    scalars = (ave, lower, upper, log_p, log_q, log_prior)
    if out.device.type == "cpu":
        emissions_plain(out, c, f, flag, kmask, bits, local, gt0, state_u,
                        smask, *scalars)
        return
    if out.numel() == 0:
        return
    G, N, S = out.shape
    K, W = bits.shape[2], bits.shape[3]
    lib = build()
    dev = out.device
    with torch.cuda.device(dev):
        rc = lib.vg_emissions(
            c.data_ptr(), f.data_ptr(), flag.data_ptr(), kmask.data_ptr(),
            bits.data_ptr(), local.data_ptr(), gt0.data_ptr(),
            state_u.data_ptr(), smask.data_ptr(), out.data_ptr(), G, N, S, K,
            W, state_u.shape[2], *(float(x) for x in scalars),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emissions kernel launch failed: CUDA error {rc}")
    LAUNCHES["emissions"] += 1
