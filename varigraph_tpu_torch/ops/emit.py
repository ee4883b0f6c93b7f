"""The genotyping emissions: the plain torch version with the kernel's
contract.

``emissions_plain(out, c, f, flag, kmask, bits, local, gt0, state_u, smask,
ave, lower, upper, log_p, log_q, log_prior)`` writes into ``out`` [G, N, S]
the log-emission of every node row and state of G windows, as
``genotype/engine_torch._emissions_body`` (the port of ``_emissions_body``,
``varigraph_tpu/genotype/engine_jax.py:70``) defines it.  It takes the
inputs as the kernel ``csrc/emit.cu`` does (``ops/emit_cuda.emissions_``),
widens them on their device, builds each window's state-count matrix from
its states' used-hap slots and calls that body.  The tests and the smoke
hold the kernel against it.

Arguments (all contiguous, on one device): out float32 [G, N, S]; c, f
uint8 [G, N, K]; flag, kmask bool [G, N, K]; bits, local int32 [G, N, K, W],
the used haps' uint32 words (hap u is bit u % 32 of word u // 32); gt0 bool
[G, N, 32 W]; state_u int32 [G, S, P], state s's used-hap slots (a
homozygous state repeats one; a masked state's row is not read); smask bool
[G, S]; six float32-representable scalars.
"""

from __future__ import annotations

import contextlib

import torch


def state_counts(state_u: torch.Tensor, smask: torch.Tensor, U: int) -> torch.Tensor:
    """[G, S, P] used-hap slots -> [G, U, S] float32 copy counts of each
    valid state (a masked state's column is 0), on state_u's device."""
    G, S, P = state_u.shape
    dev = state_u.device
    cnt = torch.zeros((G, U, S), dtype=torch.float32, device=dev)
    valid = smask[:, :, None].expand(G, S, P)
    g = torch.arange(G, device=dev)[:, None, None].expand(G, S, P)[valid]
    s = torch.arange(S, device=dev)[None, :, None].expand(G, S, P)[valid]
    u = state_u[valid].long()
    cnt.index_put_((g, u, s), torch.ones_like(u, dtype=torch.float32),
                   accumulate=True)
    return cnt


def _words(w: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values in int64 (torch has few uint32
    operations)."""
    return w.to(torch.int64) & 0xFFFFFFFF


@contextlib.contextmanager
def _full_float32_matmul(device: torch.device):
    """On a CUDA device, the body's contractions in full float32: TF32 keeps
    ~3 decimal digits, too few for the 2e-3 GPP agreement with the oracle
    engines.  The setting is process-wide, so it is restored after."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def emissions_plain(out, c, f, flag, kmask, bits, local, gt0, state_u, smask,
                    ave, lower, upper, log_p, log_q, log_prior) -> None:
    """out[g, n, s] = the log-emission of node row (g, n) in state s, -inf
    for a masked state (see the module docstring)."""
    from ..genotype import engine_torch

    cnt = state_counts(state_u, smask, gt0.shape[-1])
    with _full_float32_matmul(out.device):
        out.copy_(engine_torch._emissions_body(
            c.to(torch.int32), f.to(torch.int32), flag, kmask, _words(bits),
            _words(local), gt0, cnt, smask, ave, lower, upper, log_p, log_q,
            log_prior))
