"""Times a checkout's sketch kernels (csrc/sketch.cu) on fixed inputs, for an
A/B of two checkouts on one card.

    python3 tools/sketch_ab.py [--root DIR]

Imports ``varigraph_tpu_torch`` from DIR (default: this checkout), builds its
``csrc/sketch.cu`` and times, with CUDA events (median of 7 after a warm-up):
- ``ops/sketch_cuda.count_codes_`` on a random 50 Mb chromosome (torch seed
  3 on the card, as chip_smoke.py's phase 7) against two tables of random
  k = 27 keys (numpy seed 11): 2,904,480 keys (the 100 Mb graph's table,
  directory 2^20) and 24,000,000 (directory 2^22), with the table's key
  bitmap built once beside its directory, outside the timing, where the
  checkout's ``count_codes_`` takes one;
- ``ops/sketch_cuda.sketch_contexts`` on 100,083 random contexts of 27 to
  112 bases (numpy seed 12, 1% N), phase 9's count and length range.
Each is first held against the checkout's plain version (exactly equal).
``ptxas`` holds ptxas's report on each kernel of the checkout's sketch.cu
(registers, spills, stack), from a second build with -Xptxas -v.  Prints
one JSON line.  Run each checkout in its own process, in turns within one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 27
CHROM_BASES = 50_000_000
TABLES = {"2.9M keys": 2_904_480, "24M keys": 24_000_000}
N_CONTEXTS, CONTEXT_LENS = 100_083, (27, 112)
RUNS = 7


def time_ms(call, before=None) -> float:
    call()
    times = []
    for _ in range(RUNS):
        if before is not None:
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


def ptxas_report(cuda_build) -> list[str]:
    """ptxas's lines on each kernel of the checkout's sketch.cu: a build with
    the checkout's flags and -Xptxas -v into a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", os.path.join(tmp, "sketch.so"),
                            os.path.join(cuda_build.CSRC, "sketch.cu")],
                           capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on sketch.cu:\n{r.stderr}")
    keep = ("Compiling entry", "Used", "spill", "stack frame")
    return [ln.split("ptxas info    : ")[-1].strip() for ln in r.stderr.splitlines()
            if any(k in ln for k in keep)]


def random_keys(m: int, rng, dev) -> torch.Tensor:
    """m unique k = 27 encodings (a 54-bit hash << 8 | 27), sorted."""
    h = np.unique(rng.integers(0, 1 << 54, int(m * 1.01), dtype=np.uint64))
    h = rng.permutation(h)[:m]
    keys = np.sort(h << np.uint64(8) | np.uint64(K))
    return torch.from_numpy(keys.view(np.int64)).to(dev)


def random_contexts(rng) -> tuple[np.ndarray, np.ndarray]:
    lens = rng.integers(CONTEXT_LENS[0], CONTEXT_LENS[1] + 1, N_CONTEXTS)
    offsets = np.zeros(N_CONTEXTS + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.choice(5, int(offsets[-1]), p=[0.2475] * 4 + [0.01]).astype(np.uint8)
    return codes, offsets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose varigraph_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not torch.cuda.is_available():
        print("sketch_ab: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from varigraph_tpu_torch.ops import cuda_build, sketch_cuda
    from varigraph_tpu_torch.ops.sketch import count_codes_plain, sketch_contexts_plain
    from varigraph_tpu_torch.ops.table import directory_bits, key_directory

    if not os.path.realpath(sketch_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {sketch_cuda.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    sketch_cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"root": root, "card": smi.stdout.strip(), "ms": {}, "keys_hit": {},
           "ptxas": ptxas_report(cuda_build)}
    gen = torch.Generator(device=dev).manual_seed(3)
    chrom = torch.randint(0, 4, (CHROM_BASES,), generator=gen, device=dev,
                          dtype=torch.uint8)
    rng = np.random.default_rng(11)
    # a checkout whose count takes the table's bitmap gets it built here
    with_bitmap = "bitmap" in inspect.signature(sketch_cuda.count_codes_).parameters
    for label, m in TABLES.items():
        keys = random_keys(m, rng, dev)
        table = [key_directory(keys, directory_bits(m))]
        if with_bitmap:
            from varigraph_tpu_torch.ops.sketch import bitmap_bits
            table.append(sketch_cuda.key_bitmap(keys, bitmap_bits(m)))
        cov = torch.zeros(m, dtype=torch.int32, device=dev)
        want = torch.zeros_like(cov)
        sketch_cuda.count_codes_(cov, keys, *table, chrom, K)
        count_codes_plain(want, keys, chrom, K)
        if not torch.equal(cov, want):
            raise RuntimeError(f"count_codes differs from plain against {label}")
        out["keys_hit"][label] = int(cov.count_nonzero())
        out["ms"][f"count_codes {label}"] = time_ms(
            lambda: sketch_cuda.count_codes_(cov, keys, *table, chrom, K),
            before=cov.zero_)
        del keys, table, cov, want
        torch.cuda.empty_cache()
    codes, offsets = (torch.from_numpy(a).to(dev) for a in random_contexts(
        np.random.default_rng(12)))
    got = sketch_cuda.sketch_contexts(codes, offsets, K)
    want = sketch_contexts_plain(codes, offsets, K)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("sketch_contexts differs from plain")
    out["ms"]["sketch_contexts"] = time_ms(
        lambda: sketch_cuda.sketch_contexts(codes, offsets, K))
    out["context_values"] = int(got[0].numel())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
