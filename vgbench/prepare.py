"""A cell's inputs, made in a process of their own before the measured one
starts: the panel's FASTA and VCF (cached by configuration), the graph the
port builds from them (cached by configuration and the port's sources), the
port's kernel libraries, the run's two samples' reads from ``--seed`` and,
for a cell that genotypes from saved counts, those counts (both cached by
seed, for the newest ``SEEDS_KEPT`` seeds of a panel and traffic).

    python -m vgbench.prepare --workload CELL --seed N [--device cuda]

prints one JSON line: the paths the run reads.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

import numpy as np

from . import spec
from .gen import panel as gen

PORT = os.path.join(spec.ROOT, "varigraph_tpu_torch")
SEEDS_KEPT = 12
KERNEL_LIBS = ("libvgemit.so", "libvgfb.so", "libvgjoin.so", "libvgcbf.so",
               "libvgsketch.so", "libvgfastq.so")


def panel_dir(config: dict, layout: spec.Layout) -> tuple[str, str]:
    key = spec.digest(config["data_seed"], config["genome_mb"], config["panel"],
                      "file:" + gen.__file__)
    return os.path.join(layout.cache, "panel", f"{config['name']}-{key}"), key


def ensure_panel(config: dict, layout: spec.Layout) -> tuple[str, str, str]:
    """(directory, ref.fa, vars.vcf.gz) of the configuration's panel; the
    directory also holds the panel itself (panel.npz)."""
    d, _ = panel_dir(config, layout)
    fa, vcf = os.path.join(d, "ref.fa"), os.path.join(d, "vars.vcf.gz")
    if not all(os.path.exists(f) for f in (fa, vcf, os.path.join(d, "panel.npz"))):
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        panel = gen.make_panel(config)
        gen.write_panel(panel, tmp)
        gen.save_panel(panel, os.path.join(tmp, "panel.npz"))
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
    return d, fa, vcf


def port_digest() -> str:
    return spec.digest(*("file:" + f for f in spec.tree_files(
        PORT, (".py", ".cu", ".cuh", ".cpp"))))


def ensure_graph(config: dict, layout: spec.Layout, fa: str, vcf: str,
                 device: str) -> str:
    """The .vgt the port's construct builds from the panel."""
    _, pkey = panel_dir(config, layout)
    g = config["genotype"]
    key = spec.digest(pkey, g["k"], port_digest())
    path = os.path.join(layout.cache, "graph", f"{config['name']}-{key}.vgt")
    if not os.path.exists(path):
        from varigraph_tpu_torch.config import VarigraphConfig
        from varigraph_tpu_torch.index.build import construct_graph_index
        from varigraph_tpu_torch.index.serialize import save_graph

        os.makedirs(os.path.dirname(path), exist_ok=True)
        cfg = VarigraphConfig(ref_file=fa, vcf_file=vcf,
                              vcf_ploidy=config["panel"]["ploidy"],
                              kmer_len=g["k"], device=device)
        gi = construct_graph_index(cfg)
        save_graph(gi, path + ".tmp")
        os.replace(path + ".tmp", path)
    return path


def kernels_stale() -> bool:
    from varigraph_tpu_torch import BUILD_DIR

    sources = (glob.glob(os.path.join(PORT, "csrc", "*"))
               + glob.glob(os.path.join(PORT, "native", "*.cpp")))
    newest = max(os.path.getmtime(f) for f in sources)
    for lib in KERNEL_LIBS:
        p = os.path.join(BUILD_DIR, lib)
        if not os.path.exists(p) or os.path.getmtime(p) < newest:
            return True
    return False


def build_kernels() -> None:
    """Every kernel library and the FASTQ reader, so that no build lands in
    the measured process."""
    from varigraph_tpu_torch.native.loader import get_fastq_lib
    from varigraph_tpu_torch.ops import (cbf_cuda, emit_cuda, fb_cuda,
                                         join_cuda, sketch_cuda)

    for m in (emit_cuda, fb_cuda, join_cuda, cbf_cuda, sketch_cuda):
        m.build()
    get_fastq_lib()


def ensure_samples(workload: dict, seed: int, layout: spec.Layout,
                   pdir: str) -> tuple[list[dict], str]:
    """The run's two samples, drawn from ``seed``: reads written as gzip
    FASTQ, ``files_per_sample`` files each, cached by panel, traffic and
    seed.  Returns the samples and their directory."""
    tr = workload["traffic"]
    base = os.path.join(layout.cache, "reads",
                        f"{os.path.basename(pdir)}-{spec.digest(tr)}")
    d = os.path.join(base, str(seed))
    listing = os.path.join(d, "samples.json")
    if not os.path.exists(listing):
        panel = gen.load_panel(os.path.join(pdir, "panel.npz"))
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                     0x76676263])
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        out = []
        for tag in ("a", "b"):
            haps = gen.make_sample(panel, rng, tr)
            reads = gen.simulate_reads(haps, len(panel.genome), rng, tr)
            files = [f"{tag}_{i}.fq.gz" for i in range(int(tr["files_per_sample"]))]
            gen.write_fastq(reads, [os.path.join(tmp, f) for f in files])
            out.append({"name": f"sample_{tag}", "files": files,
                        "reads": int(len(reads))})
        with open(os.path.join(tmp, "samples.json"), "w") as fh:
            json.dump(out, fh)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
    os.utime(d)
    kept = sorted((os.path.join(base, x) for x in os.listdir(base)
                   if not x.endswith(".tmp")), key=os.path.getmtime)
    for old in kept[:-SEEDS_KEPT]:
        shutil.rmtree(old, ignore_errors=True)
    with open(listing) as fh:
        samples = json.load(fh)
    for s in samples:
        s["fastq"] = [os.path.join(d, f) for f in s.pop("files")]
    return samples, d


def ensure_sample_counts(graph: str, samples: list[dict], sample_dir: str,
                         device: str) -> None:
    """Each sample's counts, as ``genotype --save-counts`` saves them,
    cached beside its reads by graph."""
    g = os.path.splitext(os.path.basename(graph))[0]
    for s in samples:
        s["counts"] = os.path.join(sample_dir, f"{s['name']}.{g}.counts.npz")
    todo = [s for s in samples if not os.path.exists(s["counts"])]
    if not todo:
        return
    from varigraph_tpu_torch.config import VarigraphConfig
    from varigraph_tpu_torch.genotype.counting import count_reads
    from varigraph_tpu_torch.genotype.pipeline import save_counts
    from varigraph_tpu_torch.index.serialize import load_graph

    cfg = VarigraphConfig(device=device)
    gi = load_graph(graph, device=cfg.torch_device())
    for s in todo:
        base = count_reads(gi.table, s["fastq"], gi.kmer_len, cfg.read_batch_size,
                           cfg.max_read_len, io_threads=cfg.threads)
        save_counts(gi, s["counts"] + ".tmp.npz", base)
        os.replace(s["counts"] + ".tmp.npz", s["counts"])
        gi.table.reset_cov()


def prepare(cell_name: str, seed: int, device: str,
            layout: spec.Layout | None = None) -> dict:
    layout = layout or spec.Layout()
    cell = spec.load_cell(cell_name, layout)
    config, workload = cell.config, cell.workload
    t0 = time.perf_counter()
    pdir, fa, vcf = ensure_panel(config, layout)
    run_dir = os.path.join(layout.cache, "run", cell_name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    samples, sample_dir = ensure_samples(workload, seed, layout, pdir)
    t_data = time.perf_counter() - t0
    if device == "cuda" and kernels_stale():
        build_kernels()
    graph = ensure_graph(config, layout, fa, vcf, device)
    if workload["operation"] == "genotype_counts":
        ensure_sample_counts(graph, samples, sample_dir, device)
    return {"panel_dir": pdir, "fasta": fa, "vcf": vcf, "graph": graph,
            "run_dir": run_dir, "samples": samples, "data_s": t_data,
            "prepare_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", default="", help="a JSON Layout (tests)")
    a = ap.parse_args(argv)
    layout = spec.Layout(**json.loads(a.layout)) if a.layout else spec.Layout()
    out = prepare(a.workload, a.seed, a.device, layout)
    sys.stdout.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
