"""Wrapper of the CUDA posterior kernel (``csrc/post.cu``).

``posterior_(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask, bits)``
reduces each real node row of G windows from its forward and backward
chains to its record's numbers: the contract of ``ops/post.posterior_plain``,
whose module docstring lists the arguments and the layout of ``out``.  It
replaces no TPU or XLA kernel: the JAX engine's posterior is host numpy too
(``varigraph_tpu/genotype/engine_jax.py:788``).  On the card it saves the
copy of alpha and beta to the host and the host's float64 pass over them:
only ``out`` (16 + 8 P bytes a node) and the alpha and beta rows of
fallback nodes come back.

On CPU tensors it runs the plain version, ``ops/post.posterior_plain``.  On
CUDA tensors it launches the kernel or raises: a failed build or launch is an
error, never a quiet fall back to plain code.  The kernel runs on the
tensors' device and its current stream and does not wait for the card; a
valid state's slot outside 0..32 W - 1 raises ValueError on the CPU and
fails a device assert on the card.

``LAUNCHES["posterior"]`` counts kernel launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary
from .post import posterior_plain, row_width

MAX_PLOIDY = 8


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_posterior.restype = i
    lib.vg_posterior.argtypes = [p] * 11 + [n, n, i, i, i, i, p]


_LIB = KernelLibrary("post.cu", "libvgpost.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the posterior library; raises
    RuntimeError when nvcc fails."""
    return _LIB.load()


def _check(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask,
           bits) -> None:
    for name, t, dim in (("alpha", alpha, 3), ("state_u", state_u, 3),
                         ("bits", bits, 4)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    G, N, S = alpha.shape
    P = state_u.shape[2]
    K, W = bits.shape[2], bits.shape[3]
    if not 1 <= P <= MAX_PLOIDY:
        raise ValueError(f"P must be in 1..{MAX_PLOIDY}, got {P}")
    if W < 1:
        raise ValueError("bits must hold at least one word a k-mer")
    args = [("out", out, torch.int32, (G, N, row_width(P))),
            ("alpha", alpha, torch.float32, (G, N, S)),
            ("beta", beta, torch.float32, (G, N, S)),
            ("kind", kind, torch.int32, (G, N)),
            ("gt", gt, torch.uint8, (G, N, 32 * W)),
            ("state_u", state_u, torch.int32, (G, S, P)),
            ("smask", smask, torch.bool, (G, S)),
            ("c", c, torch.uint8, (G, N, K)),
            ("f", f, torch.uint8, (G, N, K)),
            ("kmask", kmask, torch.bool, (G, N, K)),
            ("bits", bits, torch.int32, (G, N, K, W))]
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
        if t.device != alpha.device:
            raise ValueError(f"{name} is on {t.device}, alpha on {alpha.device}")
    if alpha.device.type not in ("cpu", "cuda"):
        raise ValueError(f"posterior_ runs on cpu or cuda, not {alpha.device}")
    if alpha.device.type == "cuda":
        return   # the kernel checks the slots: no host sync here
    slots = state_u[smask]
    if slots.numel() and bool(((slots < 0) | (slots >= 32 * W)).any()):
        raise ValueError(f"a valid state's slot is outside 0..{32 * W - 1}")


def posterior_(out: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               kind: torch.Tensor, gt: torch.Tensor, state_u: torch.Tensor,
               smask: torch.Tensor, c: torch.Tensor, f: torch.Tensor,
               kmask: torch.Tensor, bits: torch.Tensor) -> None:
    """Fills ``out`` [G, N, 4 + 2P] in place (see ``ops/post.py``)."""
    _check(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask, bits)
    if alpha.device.type == "cpu":
        posterior_plain(out, alpha, beta, kind, gt, state_u, smask, c, f, kmask,
                        bits)
        return
    if out.numel() == 0:
        return
    G, N, S = alpha.shape
    K, W, P = bits.shape[2], bits.shape[3], state_u.shape[2]
    lib = build()
    dev = alpha.device
    with torch.cuda.device(dev):
        rc = lib.vg_posterior(
            alpha.data_ptr(), beta.data_ptr(), kind.data_ptr(), gt.data_ptr(),
            state_u.data_ptr(), smask.data_ptr(), c.data_ptr(), f.data_ptr(),
            kmask.data_ptr(), bits.data_ptr(), out.data_ptr(), G, N, S, K, W, P, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"posterior kernel launch failed: CUDA error {rc}")
    LAUNCHES["posterior"] += 1
