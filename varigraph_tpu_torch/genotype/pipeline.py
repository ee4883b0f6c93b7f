"""Genotype-phase orchestration (reference Varigraph::fastq_genotype,
src/varigraph.cpp:153-209): load graph -> per sample: count reads on the
device, estimate the coverage model, run the scoring engine, write the VCF,
reset the coverage.

Several processes (parallel/dist.py, the JAX pipeline.py:115-139,178): each
counts its round-robin share of a sample's FASTQ files, the counts merge
across the processes, and only rank 0 writes the VCF and the counts
checkpoint; every process keeps the same state for the next sample."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import VarigraphConfig
from ..index.serialize import load_graph
from ..index.structs import GraphIndex
from ..ops.cuda_build import LAUNCHES
from ..parallel import dist
from ..parallel.mesh import Mesh, make_mesh
from ..utils.log import log
from .counting import count_reads
from .coverage import estimate_hap_coverage
from .engine_np import genotype_np, graph2node
from .vcfout import write_vcf


def parse_sample_config(path: str) -> list[tuple[str, list[str]]]:
    """Parse 'sample r1.fq.gz r2.fq.gz ...' lines (varigraph.cpp:104-146)."""
    log(f"Starting to parse the samples configuration file: {path}")
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) <= 1:
                raise ValueError(
                    "The samples configuration file is missing sequencing file "
                    f"information ({line})."
                )
            sample, files = parts[0], parts[1:]
            for f in files:
                if not os.path.exists(f) or os.path.getsize(f) == 0:
                    raise FileNotFoundError(
                        f"File '{f}' does not exist or is empty."
                    )
            out.append((sample, files))
    log(f"Number of samples: {len(out)}")
    return out


def save_counts(gi: GraphIndex, path: str, read_base: int) -> None:
    """Persist the counted-reads state, in the JAX package's npz format."""
    log(f"Reads index saved to file: {path}", func="save_counts")
    with open(path, "wb") as fh:
        np.savez_compressed(fh, cov=gi.table.cov.cpu().numpy().astype(np.uint32),
                            keys=gi.table.keys_np()[:8],
                            read_base=np.uint64(read_base))


def load_counts(gi: GraphIndex, path: str) -> int:
    """Load a counted-reads checkpoint into gi.table.cov (in place); returns
    the stored read-base total.  Checks the table length and the stored
    leading keys against the loaded graph."""
    log(f"Reads index loaded from file: {path}", func="load_counts")
    with np.load(path) as z:
        cov, keys8, read_base = z["cov"], z["keys"], int(z["read_base"])
    if len(cov) != gi.table.size or not np.array_equal(keys8,
                                                        gi.table.keys_np()[:8]):
        raise ValueError(
            f"counts checkpoint '{path}' does not match the graph (table "
            f"size {gi.table.size} vs {len(cov)}, or other keys)"
        )
    gi.table.cov.copy_(torch.from_numpy(cov.astype(np.int32)))
    return read_base


def genotype_one_sample(
    gi: GraphIndex,
    cfg: VarigraphConfig,
    sample_name: str,
    fastq_files: list[str],
    out_dir: str = ".",
    counts_in: str | None = None,
    counts_out: str | None = None,
    mesh: Mesh | None = None,
) -> str:
    """Count + genotype one sample; returns the output VCF path.  mesh: the
    devices counting and the forward/backward are spread over."""
    multi = dist.process_count() > 1
    rank0 = dist.process_index() == 0
    _t0 = time.perf_counter()
    if counts_in:
        read_base = load_counts(gi, counts_in)
    else:
        read_base = count_reads(
            gi.table, dist.assign_files_to_process(fastq_files), gi.kmer_len, cfg.read_batch_size,
            cfg.max_read_len, io_threads=cfg.threads, mesh=mesh,
        )
        if multi:
            read_base = dist.merge_counts_across_hosts(gi.table.cov, read_base)
        if counts_out and rank0:
            # every process holds the same merged state; one writer
            save_counts(gi, counts_out, read_base)
    log(f"phase timing: counting {time.perf_counter() - _t0:.2f}s",
        func="genotype_one_sample")
    read_depth = read_base / float(gi.genome_size)

    _t0 = time.perf_counter()
    cov_u8 = gi.table.cov_u8()
    freq = gi.table.freq_np()
    hap_words = gi.table.hap_words_np()  # packed; never unpacked globally
    hap_cov = estimate_hap_coverage(
        cov_u8, freq, hap_words, gi.nhap, gi.vcf_ploidy, cfg.sample_ploidy,
        read_depth, cfg.use_depth,
    )
    log(f"phase timing: coverage model {time.perf_counter() - _t0:.2f}s",
        func="genotype_one_sample")
    log(f"Size of the sequenced data: {read_base / 1e9:.2f} Gb")
    log(f"Depth of the sequenced data: {read_depth:.2f}")
    log(f"Coverage of haplotype k-mers: {hap_cov:.2f}")

    log("Genotyping ...", func="genotype")
    log("Applying forward and backward algorithm ...", func="genotype")
    if cfg.debug and cfg.engine != "np":
        log("Debug mode: using the host oracle engine for verbose traces.",
            func="genotype")
        cfg.engine = "np"
    _t0 = time.perf_counter()
    host_arrays = (cov_u8, freq, hap_words, gi.table.refflag_np())
    if cfg.engine == "np":
        results = genotype_np(gi, cfg, hap_cov, cfg.seed, host_arrays)
    else:
        from .engine_torch import genotype_torch

        results = genotype_torch(gi, cfg, hap_cov, cfg.seed, host_arrays,
                                 device=cfg.torch_device(), mesh=mesh)
    log(f"phase timing: scoring {time.perf_counter() - _t0:.2f}s",
        func="genotype_one_sample")

    out_path = os.path.join(out_dir, f"{sample_name}.varigraph.vcf.gz")
    if rank0:
        os.makedirs(out_dir, exist_ok=True)
        _t0 = time.perf_counter()
        write_vcf(gi, results, sample_name, out_path, cfg.min_supporting_gq)
        log(f"phase timing: vcf write {time.perf_counter() - _t0:.2f}s",
            func="genotype_one_sample")
    return out_path


def run_genotype(cfg: VarigraphConfig, out_dir: str = ".",
                 mesh: Mesh | None = None) -> list[str]:
    """Full genotype phase over all samples in the config file.  mesh
    (default: ``make_mesh(cfg.mesh_devices)`` on the run's device) spreads
    counting and the forward/backward over several devices."""
    device = cfg.torch_device()
    if mesh is None:
        mesh = make_mesh(cfg.mesh_devices, device)
    samples = parse_sample_config(cfg.samples_config_file)
    gi = load_graph(cfg.input_graph_file, device=device, threads=cfg.threads)
    # loaded k / ploidy override the CLI (varigraph.cpp:86-89)
    cfg.kmer_len = gi.kmer_len
    cfg.vcf_ploidy = gi.vcf_ploidy

    log("Merging k-mer information from Genome Graph into Nodes ...",
        func="graph2node")
    graph2node(gi)

    outputs = []
    single = len(samples) == 1
    for sample_name, fastq_files in samples:
        log(f"Processing sample: {sample_name}", func="fastq_genotype")
        outputs.append(
            genotype_one_sample(
                gi, cfg, sample_name, fastq_files, out_dir,
                counts_in=cfg.load_counts_file if single else None,
                counts_out=cfg.save_counts_file if single else None,
                mesh=mesh,
            )
        )
        log(f"Sample: {sample_name} has been processed.", func="fastq_genotype")
        gi.table.reset_cov()
    if LAUNCHES:
        log(f"kernel launches: {dict(sorted(LAUNCHES.items()))}",
            func="fastq_genotype")
    return outputs
