"""Times a checkout's Bloom filter kernels on fixed inputs, for an A/B of two
checkouts on one card.

    python3 tools/cbf_ab.py [--root DIR] [--direct]

Imports ``varigraph_tpu_torch`` from DIR (default: this checkout), builds its
``csrc/cbf.cu``, and times, with CUDA events (median of 7 after a warm-up, 3
at a whole chromosome), at kh = 7 and at m = 2^25 and 2^30:
  * the key add (``cbf_add_``) and the count (``cbf_count``) of one genome
    batch's k-mers (16,384 rows of 160 bases, 2,195,456 windows);
  * construct's genome count over that batch's bases and over a whole
    50 Mb chromosome (random bases from seed 7): the old path (rows of
    16,384 x 160 through the torch ``sketch_codes``, then the key add) and,
    where the checkout has one, the fused ``cbf_add_codes_``;
  * with --direct, the direct fused apply of ``tools/cbf_direct.cu`` (one
    thread a row, an atomicCAS a position in device memory) on the same
    bases, built from this checkout: the alternative to the staged apply of
    ``cbf_add_codes_``;
  * with --profile, the device time of each kernel of one key add of the
    batch and one fused add of the chromosome (torch.profiler), at each m.
Every filter is checked against the old path's or the plain version's before
it is timed.  Prints one JSON line of milliseconds and the card.  Run each
checkout in its own process, in turns within one call: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, KH, COLS, ROWS = 27, 7, 160, 16384
STEP = COLS - (K - 1)
CHROM_BASES = 50_000_000
RUNS, CHROM_RUNS = 7, 3


def time_ms(call, before, runs=RUNS) -> float:
    call()
    times = []
    for _ in range(runs):
        before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rows_of(codes: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows r0..r1-1 of the genome-row segmentation, padded with 4."""
    n = codes.numel()
    idx = (torch.arange(r0, r1, device=codes.device)[:, None] * STEP
           + torch.arange(COLS, device=codes.device)[None, :])
    return torch.where(idx < n, codes[idx.clamp(max=n - 1)],
                       torch.full((), 4, dtype=torch.uint8, device=codes.device))


def profile(call) -> dict[str, float]:
    """Device ms of each kernel of one ``call()``, after a warm-up."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    call()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            out[e.key[:60]] = us / 1e3
    return out


def n_rows(n: int) -> int:
    return 1 if n <= COLS else -(-(n - COLS) // STEP) + 1


def build_direct(build_dir: str) -> ctypes.CDLL:
    from varigraph_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc

    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, "libcbfdirect.so")
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib,
                        os.path.join(HERE, "tools", "cbf_direct.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on tools/cbf_direct.cu:\n{r.stderr}")
    dll = ctypes.CDLL(lib)
    p, n, i = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    dll.vg_cbf_direct_add_codes.restype = i
    dll.vg_cbf_direct_add_codes.argtypes = [p, n, n, n, p, n, n, n, i, p, i, p]
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose varigraph_tpu_torch is timed")
    ap.add_argument("--direct", action="store_true",
                    help="also time the direct apply of tools/cbf_direct.cu")
    ap.add_argument("--profile", action="store_true",
                    help="also give each kernel's device time (torch.profiler)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not torch.cuda.is_available():
        print("cbf_ab: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from varigraph_tpu_torch import BUILD_DIR
    from varigraph_tpu_torch.ops import cbf_cuda
    from varigraph_tpu_torch.ops.cbf import cbf_add_plain, make_seeds
    from varigraph_tpu_torch.ops.kmer import sketch_codes

    if not os.path.realpath(cbf_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {cbf_cuda.__file__}, not from {root}")
    fused = getattr(cbf_cuda, "cbf_add_codes_", None)
    dev = torch.device("cuda", 0)
    cbf_cuda.build()
    direct = build_direct(BUILD_DIR) if args.direct else None

    seeds = torch.from_numpy(make_seeds(KH, 0).view(np.int64).copy()).to(dev)
    rng = np.random.default_rng(7)
    chrom = torch.from_numpy(rng.integers(0, 4, CHROM_BASES).astype(np.uint8)).to(dev)
    spans = {"batch": chrom[:(ROWS - 1) * STEP + COLS], "chromosome": chrom}
    values, emit = sketch_codes(rows_of(chrom, 0, ROWS), K)
    keys = values[:, K - 1:].reshape(-1).contiguous()
    mask = emit[:, K - 1:].reshape(-1).contiguous()

    def old_path(filt, codes):
        total = n_rows(codes.numel())
        for r0 in range(0, total, ROWS):
            v, e = sketch_codes(rows_of(codes, r0, min(total, r0 + ROWS)), K)
            cbf_cuda.cbf_add_(filt, v[:, K - 1:].reshape(-1).contiguous(),
                              e[:, K - 1:].reshape(-1).contiguous(), seeds)

    def direct_path(filt, codes):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = direct.vg_cbf_direct_add_codes(
            filt.data_ptr(), filt.numel(), 0, filt.numel(), codes.data_ptr(),
            codes.numel(), 0, n_rows(codes.numel()), K, seeds.data_ptr(), KH,
            stream)
        if rc:
            raise RuntimeError(f"direct kernel launch failed: CUDA error {rc}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    out = {"root": root, "card": smi[0] if smi else None, "fused": fused is not None,
           "ms": {}}
    for log2m in (25, 30):
        filt = torch.zeros(1 << log2m, dtype=torch.uint8, device=dev)
        ref = torch.zeros_like(filt)
        cbf_cuda.cbf_add_(filt, keys, mask, seeds)
        cbf_add_plain(ref, keys, mask, seeds)
        if not torch.equal(filt, ref):
            raise RuntimeError(f"key add disagrees with plain at 2^{log2m}")
        tag = f"m=2^{log2m}"
        out["ms"][f"cbf_add keys {tag}"] = time_ms(
            lambda: cbf_cuda.cbf_add_(filt, keys, mask, seeds), filt.zero_)
        out["ms"][f"cbf_count keys {tag}"] = time_ms(
            lambda: cbf_cuda.cbf_count(filt, keys, seeds), lambda: None)
        for span, codes in spans.items():
            runs = RUNS if span == "batch" else CHROM_RUNS
            ref.zero_()
            old_path(ref, codes)
            paths = {"old path": old_path}
            if fused is not None:
                paths["cbf_add_codes"] = lambda f, c: fused(f, c, K, seeds)
            if direct is not None:
                paths["direct"] = direct_path
            for name, fn in paths.items():
                filt.zero_()
                fn(filt, codes)
                torch.cuda.synchronize()
                if not torch.equal(filt, ref):
                    raise RuntimeError(f"{name} disagrees with the old path: "
                                       f"{span} {tag}")
                out["ms"][f"{name} {span} {tag}"] = time_ms(
                    lambda: fn(filt, codes), filt.zero_, runs)
        if args.profile:
            cases = {"cbf_add keys": lambda: cbf_cuda.cbf_add_(filt, keys, mask, seeds)}
            if fused is not None:
                cases["cbf_add_codes chromosome"] = lambda: fused(filt, chrom, K, seeds)
            for name, fn in cases.items():
                out.setdefault("profile_ms", {})[f"{name} {tag}"] = profile(fn)
        del filt, ref
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
