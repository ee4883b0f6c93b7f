"""Times a checkout's forward/backward kernel on fixed inputs, for an A/B of
two checkouts on one card.

    python3 tools/fb_ab.py [--root DIR]

Imports ``varigraph_tpu_torch`` from DIR (default: this checkout), builds its
``csrc/fb.cu``, and times, with CUDA events (median of 7 after a warm-up),
its ``ops/fb_cuda.forward_backward`` at two genome-scale groups: W = 256
windows of N = 8,192 real nodes, P = 2, S = 120 (-n 15) and S = 465
(-n 30), the diploid het states of the fewest haplotypes, in rec and fre
mode.  logE comes from torch seed 99 on the card, the distances from numpy
seed 99, so two checkouts see the same inputs.  Before timing, each group's
first two windows over their first 512 nodes are held against the
checkout's plain ``_forward_backward_plain`` at atol 1e-6.  Each group is
also timed at its first 2 windows in rec mode ("W=2": every CTA has an SM to
itself, so the time is a step's latency times the steps).  Where the
checkout has the class-list layout (``fb_layout``), it is timed alone too.
``ptxas`` holds ptxas's report of each kernel of the checkout's fb.cu
(registers, spills, stack), from a second build with -Xptxas -v.  Prints one
JSON line.  Run each checkout in its own process, in turns within one call:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, N, P = 256, 8192, 2
GROUP_S = (120, 465)
CHECK_W, CHECK_N = 2, 512
ATOL = 1e-6
RUNS = 7
NHAP = 101          # the 100 Mb graph's haplotypes: the distances' scale


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


def ptxas_report(cuda_build) -> list[str]:
    """ptxas's lines on each kernel of the checkout's fb.cu: a build with
    the checkout's flags and -Xptxas -v into a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", os.path.join(tmp, "fb.so"),
                            os.path.join(cuda_build.CSRC, "fb.cu")],
                           capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on fb.cu:\n{r.stderr}")
    keep = ("Compiling entry", "Used", "spill", "stack frame")
    return [ln.split("ptxas info    : ")[-1].strip() for ln in r.stderr.splitlines()
            if any(k in ln for k in keep)]


def group_inputs(et, increment_vector, S: int, dev) -> list[torch.Tensor]:
    """(logE, kind, lrf, lnrf, lrb, lnrb, overlap, log_w, smask) of the group
    at S states, on the card."""
    h = 1
    while h * (h + 1) // 2 < S:
        h += 1
    states = increment_vector(list(range(h)), "het", 2, h - 1)[:S]
    ov = np.broadcast_to(et.state_overlap(states), (W, S, S)).copy()
    rng = np.random.default_rng(99)
    dist = rng.integers(0, 200_000, (W, 2, N))
    gen = torch.Generator(device=dev).manual_seed(99)
    logE = (torch.randn((W, N, S), generator=gen, device=dev) * 6.0 - 40.0).contiguous()
    w = rng.random((W, S))
    log_w = np.log(w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    lrf, lnrf = et._transition_logs(dist[:, 0], NHAP)
    lrb, lnrb = et._transition_logs(dist[:, 1], NHAP)
    host = [np.ones((W, N), np.int32), lrf, lnrf, lrb, lnrb, ov, log_w]
    return [logE, *(torch.from_numpy(a).to(dev) for a in host),
            torch.ones((W, S), dtype=torch.bool, device=dev)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose varigraph_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        print("fb_ab: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import varigraph_tpu_torch.genotype.engine_torch as et
    from varigraph_tpu_torch.genotype.combos import increment_vector
    from varigraph_tpu_torch.ops import cuda_build, fb_cuda

    if not os.path.realpath(fb_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {fb_cuda.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    fb_cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"root": root, "card": smi.stdout.strip(), "ms": {}, "max_abs_err": {},
           "ptxas": ptxas_report(cuda_build)}
    layout = getattr(fb_cuda, "fb_layout", None)
    for S in GROUP_S:
        t = group_inputs(et, increment_vector, S, dev)
        for fre in (False, True):
            mode = "fre" if fre else "rec"
            # logE and the per-node arrays cut in windows and nodes, the
            # per-window ones in windows
            sub = ([x[:CHECK_W, :CHECK_N].contiguous() for x in t[:6]]
                   + [x[:CHECK_W].contiguous() for x in t[6:]])
            got = fb_cuda.forward_backward(*sub, fre, P)
            want = et._forward_backward_plain(*sub, fre, P)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if not err <= ATOL:
                raise RuntimeError(f"S={S} {mode}: kernel vs plain {err}")
            out["max_abs_err"][f"S={S} {mode}"] = err
            out["ms"][f"S={S} {mode}"] = time_ms(
                lambda: fb_cuda.forward_backward(*t, fre, P))
        two = [x[:2].contiguous() for x in t]
        out["ms"][f"S={S} rec W=2"] = time_ms(
            lambda: fb_cuda.forward_backward(*two, False, P))
        del two
        if layout is not None:
            out["ms"][f"S={S} layout"] = time_ms(lambda: layout(t[6], P))
        del t
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
