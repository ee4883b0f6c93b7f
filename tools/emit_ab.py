"""Times a checkout's emissions kernel (csrc/emit.cu) on fixed inputs, for an
A/B of two checkouts on one card.

    python3 tools/emit_ab.py [--root DIR]

Imports ``varigraph_tpu_torch`` from DIR (default: this checkout), builds its
``csrc/emit.cu`` and, at four shapes, times two things with CUDA events
(medians of 7 after a warm-up):
- the bare kernel: ``RUNS_BARE`` back-to-back ``vg_emissions`` launches on
  pointers prepared once, divided by their number;
- the call: one ``ops/emit_cuda.emissions_`` as the engine makes it, with its
  argument checks, between two events (as ``chip_smoke.time_ms`` times it).
The shapes are those of ``chip_smoke.py``'s phase 16, built from numpy seeds
as its ``emit_group`` builds them (each node a prefix of 1..128 valid
k-mers, coverage Poisson(10), frequencies 1-4, ref flags at 0.3, random hap,
local and gt0 bits, ave 10.3; this checkout's ``tests/test_torch_emit``
helpers): ``100mb`` G = 100 windows of N = 543 nodes,
S = 120 (the het pairs of 16 haplotypes), P = 2, W = 1 (phase 14's group);
``s465``, ``p4`` and ``w2`` 32 x 543 nodes at S = 465 (-n 30), at P = 4 (330
states of 8 haplotypes) and at W = 2 (135 states over 40 haplotypes).
Before timing, each shape's kernel output is held against the checkout's
plain ``emissions_plain`` on its first 2 windows (rtol 4e-6, -inf and NaN at
the same places).  ``sha256`` is the digest of each shape's output bytes,
so two checkouts whose kernels sum in the same order print the same digest.
``bound_ms`` is ``chip_smoke.emit_bound``'s: each input read once and logE
written once, against 2P + 1 int32 operations a (node, valid k-mer, valid
state) triple.  ``ptxas`` holds ptxas's report on each kernel of the
checkout's emit.cu (registers, spills, stack), from a second build with its
flags and -Xptxas -v.  Prints one JSON line.  Run each checkout in its own
process, in turns within one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the input helpers of this checkout's tests (they import the timed
# checkout's package: DIR goes first on the path)
sys.path.insert(0, os.path.join(HERE, "tests"))
N, K = 543, 128
RUNS, RUNS_BARE = 7, 50
RTOL = 4e-6
CHECK_G = 2
HBM_BYTES_PER_S, INT32_OPS_PER_S = 3.35e12, 67e12 / 4


def _pairs(n: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


# name: (windows, states, used haplotypes, numpy seed)
SHAPES = {
    "100mb": (100, _pairs(16), 16, 159),
    "s465": (32, _pairs(31), 31, 160),
    "p4": (32, list(itertools.combinations_with_replacement(range(8), 4)), 8, 161),
    "w2": (32, _pairs(40)[::6] + [(u, u) for u in range(0, 40, 8)], 40, 162),
}


def time_ms(call) -> float:
    call()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report(cuda_build, flags) -> list[str]:
    """ptxas's lines on each kernel of the checkout's emit.cu: a build with
    the checkout's flags and -Xptxas -v into a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags,
                            "-Xptxas", "-v", "-o", os.path.join(tmp, "emit.so"),
                            os.path.join(cuda_build.CSRC, "emit.cu")],
                           capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on emit.cu:\n{r.stderr}")
    keep = ("Compiling entry", "Used", "spill", "stack frame")
    return [ln.split("ptxas info    : ")[-1].strip() for ln in r.stderr.splitlines()
            if any(k in ln for k in keep)]


def group(G: int, states, n_used: int, seed: int, dev) -> list[torch.Tensor]:
    """The wrapper's tensor arguments after out: c, f, flag, kmask, bits,
    local, gt0, state_u, smask."""
    from test_torch_emit import _words as words

    rng = np.random.default_rng(seed)
    W = -(-n_used // 32)
    nk = rng.integers(1, K + 1, (G, N))
    kmask = np.arange(K)[None, None, :] < nk[..., None]
    c = rng.poisson(10.0, (G, N, K)).clip(0, 255).astype(np.uint8)
    f = rng.integers(1, 5, (G, N, K)).astype(np.uint8)
    flag = rng.random((G, N, K)) < 0.3
    bits = words(rng, (G, N, K, W), n_used).view(np.int32)
    local = words(rng, (G, N, K, W), n_used).view(np.int32)
    gt0 = rng.random((G, N, 32 * W)) < 0.5
    gt0[..., n_used:] = False
    state_u = np.repeat(np.asarray(states, np.int32)[None], G, axis=0)
    smask = np.ones((G, len(states)), bool)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (c, f, flag, kmask, bits, local, gt0, state_u, smask)]


def bound_ms(t: list[torch.Tensor], out: torch.Tensor) -> tuple[float, float]:
    """(ms, triples): the larger of the bytes and the operations bound."""
    kmask, state_u, smask = t[3], t[7], t[8]
    nbytes = sum(x.numel() * x.element_size() for x in t) + out.numel() * 4
    triples = float((kmask.sum(dim=2, dtype=torch.float64)
                     * smask.sum(dim=1, dtype=torch.float64)[:, None]).sum())
    ops = triples * (2 * state_u.shape[2] + 1)
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3, triples


def check(emit_cuda, emissions_plain, t, scal, dev) -> float:
    """The kernel against plain on the first CHECK_G windows; returns the
    max relative error of the finite values."""
    sub = [x[:CHECK_G].contiguous() for x in t]
    shape = tuple(sub[0].shape[:2]) + (sub[8].shape[1],)
    got = torch.empty(shape, dtype=torch.float32, device=dev)
    want = torch.empty_like(got)
    emit_cuda.emissions_(got, *sub, *scal)
    emissions_plain(want, *sub, *scal)
    torch.cuda.synchronize()
    for fn in (torch.isneginf, torch.isnan, torch.isfinite):
        if not torch.equal(fn(got), fn(want)):
            raise RuntimeError(f"-inf, NaN or finite values differ ({fn.__name__})")
    fin = torch.isfinite(want)
    rel = float(((got - want).abs()[fin] / want.abs()[fin].clamp_min(1e-30)).max())
    if not rel <= RTOL:
        raise RuntimeError(f"kernel vs plain max rel err {rel}")
    return rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose varigraph_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        print("emit_ab: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from test_torch_emit import _scalars
    from varigraph_tpu_torch.ops import cuda_build, emit_cuda
    from varigraph_tpu_torch.ops.emit import emissions_plain

    if not os.path.realpath(emit_cuda.__file__).startswith(os.path.realpath(root)):
        raise RuntimeError(f"imported {emit_cuda.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    lib = emit_cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"root": root, "card": smi.stdout.strip(), "shapes": {},
           "ptxas": ptxas_report(cuda_build, ("-fmad=false",))}
    scal = _scalars(10.3)
    for name, (G, states, n_used, seed) in SHAPES.items():
        t = group(G, states, n_used, seed, dev)
        S, W, P = t[8].shape[1], t[4].shape[3], t[7].shape[2]
        rel = check(emit_cuda, emissions_plain, t, scal, dev)
        out = torch.empty((G, N, S), dtype=torch.float32, device=dev)
        emit_cuda.emissions_(out, *t, *scal)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in t] + [out.data_ptr()]

        def bare():
            for _ in range(RUNS_BARE):
                rc = lib.vg_emissions(*ptrs, G, N, S, K, W, P, *scal, stream)
                if rc != 0:
                    raise RuntimeError(f"vg_emissions: CUDA error {rc}")

        b, triples = bound_ms(t, out)
        res["shapes"][name] = {
            "G": G, "N": N, "S": S, "P": P, "W": W, "triples": triples,
            "bare_ms": time_ms(bare) / RUNS_BARE,
            "call_ms": time_ms(lambda: emit_cuda.emissions_(out, *t, *scal)),
            "bound_ms": b, "max_rel_err": rel, "sha256": digest,
        }
        del t, out
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
