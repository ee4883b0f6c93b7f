"""The least time each kernel could take on one H100, from its own launch's
arguments: a frozen copy of ``chip_smoke.py``'s bound arithmetic.

Peak rates of one H100 SXM (NVIDIA's data sheet, dense): HBM3 at 3.35 TB/s,
float32 at 67 TFLOP/s outside the tensor cores, int32 at a quarter of that
(64 lanes an SM against 128).  A bound is the longer of the bytes the launch
must move over the HBM rate and the operations it must do over the rate of
their kind.  A kernel's roofline share is its bound over its device time.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4


def bound_s(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def emit_work(out, c, f, flag, kmask, bits, local, gt0, state_u, smask) -> tuple:
    """(bytes, triples, P) of one emissions launch: every input read once
    and logE (``out``) written once; triples, the (node, valid k-mer, valid
    state) triples, stays a tensor on the launch's device, so that taking
    it syncs nothing."""
    args = (c, f, flag, kmask, bits, local, gt0, state_u, smask)
    nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * 4
    triples = (kmask.sum(dim=2, dtype=torch.float64)
               * smask.sum(dim=1, dtype=torch.float64)[:, None]).sum()
    return nbytes, triples, int(state_u.shape[2])


def emit_bound_s(nbytes: float, triples: float, P: int) -> float:
    """The emissions: ``emit_work``'s bytes against 2P + 1 int32 operations
    a triple: P bit tests, P - 1 adds, the term table's index and the float
    add."""
    return bound_s(nbytes, triples * (2 * P + 1))


def fb_flow_steps(kind: np.ndarray) -> np.ndarray:
    """Each window's steps of both directions that compute a flow: real
    nodes that are not the first real node of their chain."""
    steps = np.zeros(kind.shape[0], np.int64)
    for k in (kind, kind[:, ::-1]):
        for w in range(k.shape[0]):
            real = k[w] == 1
            steps[w] += int(real.sum()) - len(np.unique(np.cumsum(k[w] == 2)[real]))
    return steps


def fb_bound_s(logE_shape, kind: np.ndarray, overlap: np.ndarray,
               smask: np.ndarray) -> float:
    """The forward/backward (rec mode): logE read once a direction and
    alpha and beta written, 4 x W*N*S float32, against 2 float32 operations
    a flow step for each of a window's valid overlap entries that are not
    class 0 (class 0 enters through the row's sum)."""
    W, N, S = logE_shape
    steps = fb_flow_steps(kind)
    valid = smask[:, :, None] & smask[:, None, :]
    nonzero = ((overlap > 0) & valid).sum(axis=(1, 2)).astype(np.float64)
    ops = float((steps * 2 * nonzero).sum())
    return bound_s(4 * W * N * S * 4, ops, FP32_FLOPS_PER_S)
