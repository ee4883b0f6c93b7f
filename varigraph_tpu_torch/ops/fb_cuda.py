"""Wrapper of the CUDA forward/backward scan (``csrc/fb.cu``).

``forward_backward(logE, kind, log_rec_f, log_norec_f, log_rec_b,
log_norec_b, overlap, log_w, smask, fre_mode, P)`` returns (alpha, beta)
[W, N, S]: the normalized forward and backward scans of every window's HMM,
as ``genotype/engine_torch._forward_backward_plain`` defines them.  It
replaces the XLA ``lax.scan`` of ``varigraph_tpu/genotype/engine_jax.py:192``
(``_forward_backward``).

On CPU tensors it runs the plain torch version,
``engine_torch._forward_backward_plain`` (``_scan`` over the P+1
overlap-class masks).  On CUDA tensors it launches the kernel or raises: a
failed build or launch is an error, never a quiet fall back to plain code.
The kernel runs on the tensors' device and its current stream.

In rec mode the kernel sums, for each state, only its column's overlap
entries that are not class 0 (class 0 weighs the same everywhere and enters
through the row's sum).  ``fb_layout`` lists them with torch operations on
the overlap's device before the launch; it runs on the CPU too, where the
tests hold it against the overlap.

The kernel is compiled from the repository's source with ``nvcc`` at first
use (``ops/cuda_build.py``).  ``LAUNCHES["forward_backward"]`` counts kernel
launches, one a call (both directions of every window).

Arguments: logE float32 [W, N, S]; kind int32 [W, N] (0 pad, 1 real, 2
reset); the four log distances float32 [W, N]; overlap int32 [W, S, S],
values >= 0 (a class above P weighs 0); log_w float32 [W, S]; smask bool [W, S]; 0 <= P <= 255;
all contiguous, on one device.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import LAUNCHES, KernelLibrary


def _declare(lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.vg_fb_max_states.restype = n
    lib.vg_fb_max_states.argtypes = []
    lib.vg_forward_backward.restype = i
    lib.vg_forward_backward.argtypes = [p] * 13 + [n, n, n, i, n, i, p]


_LIB = KernelLibrary("fb.cu", "libvgfb.so", _declare)
LIBRARY = _LIB.library


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the forward/backward library; raises
    RuntimeError when nvcc fails."""
    return _LIB.load()


def fb_layout(overlap: torch.Tensor, P: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each window's per-column lists of the overlap entries the kernel sums.

    overlap int32 [W, S, S] (ov[s, j]: state s to state j).  Column j lists
    the states s with 1 <= ov[s, j] <= P, grouped by class in ascending class
    and then s order.  A column holding a class above P (``full``) lists its
    class-0 entries too and leaves the classes above P out, so that they
    weigh 0.  Each class's group starts at the same slot in every column of
    a window, ``goff[w, c]``, and is padded with the index S to the window's
    longest, rounded up to an even count; a column's own entries of class c
    are the slots goff[w, c] .. goff[w, c] + its count - 1.

    Returns (lists int16 [W, L // 2, S, 2]: slot k of column j at
    [w, k // 2, j, k % 2], read by the kernel as one 32-bit word a slot
    pair; goff int32 [W, P + 2], goff[w, P + 1] the window's slot count;
    full bool [W, S]), on the overlap's device.
    """
    W, S, _ = overlap.shape
    if S > 32767:
        raise ValueError(f"fb_layout indexes states in int16, got S = {S}")
    dev = overlap.device
    above = overlap > P                                  # [W, s, j]
    full = above.any(dim=1)                              # [W, j]
    listed = ~above & ((overlap >= 1) | full[:, None, :])
    goff = torch.zeros((W, P + 2), dtype=torch.int32, device=dev)
    slot = torch.full((W, S, S), -1, dtype=torch.int32, device=dev)
    end = torch.zeros((W, 1, 1), dtype=torch.int32, device=dev)
    for c in range(P + 1):          # an absent class adds a group of 0 slots
        m = listed & (overlap == c)
        rank = m.cumsum(dim=1, dtype=torch.int32)        # 1-based down column j
        slot = torch.where(m, end + rank - 1, slot)
        end = end + (rank[:, -1:, :].amax(dim=2, keepdim=True) + 1) // 2 * 2
        goff[:, c + 1] = end.view(W)
    L = int(end.max()) if W else 0
    # slot k of column j at lists[w, k // 2, j, k % 2]
    w, s, j = listed.nonzero(as_tuple=True)
    k = slot[w, s, j]
    lists = torch.full((W, L // 2, S, 2), S, dtype=torch.int16, device=dev)
    lists[w, k // 2, j, k % 2] = s.to(torch.int16)
    return lists, goff, full


def _check(logE, kind, logs, overlap, log_w, smask, P: int) -> None:
    if not isinstance(logE, torch.Tensor):
        raise TypeError("logE must be a torch.Tensor")
    if logE.dim() != 3:
        raise ValueError(f"logE must be 3-D, got shape {tuple(logE.shape)}")
    W, N, S = logE.shape
    args = [("logE", logE, torch.float32, (W, N, S)),
            ("kind", kind, torch.int32, (W, N)),
            *((name, t, torch.float32, (W, N)) for name, t in logs),
            ("overlap", overlap, torch.int32, (W, S, S)),
            ("log_w", log_w, torch.float32, (W, S)),
            ("smask", smask, torch.bool, (W, S))]
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
        if t.device != logE.device:
            raise ValueError(f"{name} is on {t.device}, logE on {logE.device}")
    if not 0 <= P <= 255:
        raise ValueError(f"P must be in 0..255, got {P}")
    if logE.device.type not in ("cpu", "cuda"):
        raise ValueError(f"forward_backward runs on cpu or cuda, not {logE.device}")


def forward_backward(logE: torch.Tensor, kind: torch.Tensor,
                     log_rec_f: torch.Tensor, log_norec_f: torch.Tensor,
                     log_rec_b: torch.Tensor, log_norec_b: torch.Tensor,
                     overlap: torch.Tensor, log_w: torch.Tensor,
                     smask: torch.Tensor, fre_mode: bool,
                     P: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) [W, N, S] float32 on logE's device."""
    logs = (("log_rec_f", log_rec_f), ("log_norec_f", log_norec_f),
            ("log_rec_b", log_rec_b), ("log_norec_b", log_norec_b))
    _check(logE, kind, logs, overlap, log_w, smask, P)
    if logE.device.type == "cpu":
        from ..genotype import engine_torch

        return engine_torch._forward_backward_plain(
            logE, kind, log_rec_f, log_norec_f, log_rec_b, log_norec_b,
            overlap, log_w, smask, fre_mode, P)
    W, N, S = logE.shape
    if logE.numel() == 0:
        return torch.zeros_like(logE), torch.zeros_like(logE)
    alpha = torch.empty_like(logE)
    beta = torch.empty_like(logE)
    lib = build()
    dev = logE.device
    with torch.cuda.device(dev):
        max_states = lib.vg_fb_max_states()
        if max_states < 0:
            raise RuntimeError(f"could not read {dev}'s shared memory limit")
        if S > max_states:
            raise ValueError(f"the forward/backward kernel holds at most "
                             f"{max_states} states on {dev}, got {S}")
        if fre_mode:   # the flow is the row's sum: no lists
            lists = goff = full = torch.zeros(0, dtype=torch.int32, device=dev)
        else:
            lists, goff, full = fb_layout(overlap, P)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vg_forward_backward(
            logE.data_ptr(), kind.data_ptr(), log_rec_f.data_ptr(),
            log_norec_f.data_ptr(), log_rec_b.data_ptr(),
            log_norec_b.data_ptr(), lists.data_ptr(), goff.data_ptr(),
            full.data_ptr(), log_w.data_ptr(), smask.data_ptr(),
            alpha.data_ptr(), beta.data_ptr(), W, N, S, P,
            lists.shape[1] if lists.dim() == 4 else 0, int(bool(fre_mode)),
            stream)
    if rc != 0:
        raise RuntimeError(f"forward_backward kernel launch failed: CUDA error {rc}")
    LAUNCHES["forward_backward"] += 1
    return alpha, beta
