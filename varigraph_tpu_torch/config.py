"""Run configuration for both pipeline phases.

Mirrors the JAX package's VarigraphConfig (itself the reference's
VarigraphConfig, include/varigraph.hpp:26-103, defaults at :49-68), plus
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .utils.log import log


@dataclass
class VarigraphConfig:
    # ---- input/output ----
    ref_file: str = ""  # -r: reference FASTA (may be gzipped)
    vcf_file: str = ""  # -v: population VCF (may be gzipped)
    samples_config_file: str = ""  # -s: "sample r1.fq.gz r2.fq.gz" lines
    input_graph_file: str = "graph.vgt"  # --load-graph
    output_graph_file: str = "graph.vgt"  # --save-graph

    # ---- algorithm (construct; genotype reads k and ploidy from the graph) ----
    kmer_len: int = 27  # -k, clamp [5, 28] (main.cpp:131,187-191)
    vcf_ploidy: int = 2  # --vcf-ploidy, 2..8 (main.cpp:181-185)
    fast_mode: bool = False  # --fast (skip all-zero-GT samples when indexing)
    use_unique_kmers: bool = False  # --use-unique-kmers

    # ---- algorithm (genotype) ----
    sample_type: str = "het"  # -g: hom | het
    sample_ploidy: int = 2  # --sample-ploidy, 2..8
    haploid_num: int = 15  # -n: haplotypes used per window
    granularity_bp: int = 1_000_000  # --granularity (Mb -> bp)
    transition_pro_type: str = "rec"  # -m: rec | fre
    sv_genotype_only: bool = False  # --sv
    min_supporting_gq: float = 0.0  # --min-support
    use_depth: bool = False  # --use-depth

    # ---- runtime ----
    debug: bool = False  # -D
    threads: int = 10  # -t (FASTQ files read / context walkers)
    seed: int = 0  # deterministic seed for CBF hashing + Dirichlet draws
    engine: str = "torch"  # "torch" (device) | "np" (host oracle)
    device: str = "cuda"  # torch device of the filter, table and scoring

    # ---- read batching (no reference counterpart) ----
    read_batch_size: int = 16384  # reads per device batch
    max_read_len: int = 160  # padded read length per batch
    mesh_devices: int = 0  # 0 = all local devices
    # several processes (torch.distributed, gloo): each process streams its
    # round-robin share of a sample's FASTQ files, counts merge with one
    # collective, rank 0 writes the VCF
    coordinator: str = ""  # --coordinator host:port ("" = torchrun's env)
    num_processes: int = 0  # --num-processes (0 = single process / env)
    process_id: int = -1  # --process-id (-1 = env)
    # counted-reads checkpoint (single-sample runs): skip or persist counting
    load_counts_file: str = ""
    save_counts_file: str = ""

    # -------------------------------------------------------------- validation
    def validate_construct(self) -> None:
        if not self.ref_file:
            raise ValueError("reference FASTA (-r) cannot be empty")
        if not self.vcf_file:
            raise ValueError("VCF file (-v) cannot be empty")
        if not self.output_graph_file:
            raise ValueError("--save-graph cannot be empty")
        if not (2 <= self.vcf_ploidy <= 8):
            raise ValueError("--vcf-ploidy must be between 2 and 8")
        if not (5 <= self.kmer_len <= 28):
            raise ValueError("-k must be between 5 and 28")
        self.torch_device()

    def validate_genotype(self) -> None:
        if not self.input_graph_file:
            raise ValueError("--load-graph cannot be empty")
        if not self.samples_config_file:
            raise ValueError("samples configuration file (-s) cannot be empty")
        if self.sample_type not in ("hom", "het"):
            raise ValueError("-g must be 'hom' or 'het'")
        if not (2 <= self.sample_ploidy <= 8):
            raise ValueError("--sample-ploidy must be between 2 and 8")
        if self.haploid_num == 0:
            raise ValueError("-n must be greater than 0")
        if self.haploid_num < 10:
            log("Parameter warning: -n is relatively low; genotyping accuracy may drop.")
        if self.granularity_bp < 1:
            raise ValueError("--granularity must be >= 1 bp")
        if self.transition_pro_type not in ("fre", "rec"):
            raise ValueError("-m must be 'fre' or 'rec'")
        if self.engine not in ("torch", "np"):
            raise ValueError("--engine must be 'torch' or 'np'")
        self.torch_device()

    def torch_device(self) -> torch.device:
        """The run's torch.device.  A run that asks for CUDA on a machine
        without it fails here; it never carries on on the CPU."""
        if self.device not in ("cuda", "cpu"):
            raise ValueError("--device must be 'cuda' or 'cpu'")
        if self.device == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                "--device cuda was requested but torch finds no CUDA device "
                "(pass --device cpu to run on the CPU)"
            )
        return torch.device(self.device)

    # ---------------------------------------------------------------- logging
    def log_construct(self) -> None:
        log(f"Number of threads: {self.threads}")
        log(f"k-mer size: {self.kmer_len}")
        log(f"Reference file path: {self.ref_file}")
        log(f"Variants file path: {self.vcf_file}")
        log(f"Ploidy of genotypes in the VCF file: {self.vcf_ploidy}")
        log(f"Fast mode: {'Enabled' if self.fast_mode else 'Disabled'}")
        log(f"Use only unique k-mers for indexing: "
            f"{'Enabled' if self.use_unique_kmers else 'Disabled'}")
        log(f"Device: {self.device}")
        log(f"Deterministic seed: {self.seed}")

    def log_genotype(self) -> None:
        log(f"Number of threads: {self.threads}")
        log(f"Genome graph file: {self.input_graph_file}")
        log(f"Sample configuration file: {self.samples_config_file}")
        log(f"Sample genome status: {self.sample_type}")
        log(f"Sample ploidy: {self.sample_ploidy}")
        log(f"Number of haploids for genotyping: {self.haploid_num}")
        log(f"Chromosome granularity: {self.granularity_bp} bp")
        log(f"Transition probability type: {self.transition_pro_type}")
        log(f"Structural variation genotyping only: "
            f"{'Enabled' if self.sv_genotype_only else 'Disabled'}")
        log(f"Minimum site quality (GQ): {self.min_supporting_gq}")
        log(f"Use sequencing depth for homozygous k-mers: "
            f"{'Enabled' if self.use_depth else 'Disabled'}")
        log(f"Genotyping engine: {self.engine}")
        log(f"Device: {self.device}")
        log(f"Device read batch: {self.read_batch_size} reads x "
            f"{self.max_read_len} bp")
        log(f"Deterministic seed: {self.seed}")
