"""Command-line interface: ``python -m varigraph_tpu_torch construct|genotype``.

The subcommands of ``varigraph_tpu/cli.py`` (itself mirroring the reference's
main.cpp:76-235 construct and :238-445 genotype), plus ``--device``.
Genotype runs over several devices (``--mesh-devices``) and several
processes (``--coordinator``, ``--num-processes``, ``--process-id``, or
torchrun's environment).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .config import VarigraphConfig
from .utils.log import log
from .utils.timing import report


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the run; cuda fails when no CUDA "
                        "device is present [cuda]")


def _add_construct(sub):
    p = sub.add_parser(
        "construct",
        help="Construct a genome graph from the reference genome and variants.",
    )
    p.add_argument("-r", "--reference", required=True, metavar="FILE",
                   help="input FASTA reference file")
    p.add_argument("-v", "--vcf", required=True, metavar="FILE",
                   help="VCF file for index building")
    p.add_argument("--save-graph", default="graph.vgt", metavar="FILE",
                   help="save Genome Graph index to file [graph.vgt]")
    p.add_argument("--vcf-ploidy", type=int, default=2, metavar="INT",
                   help="ploidy of genotypes in VCF file (2-8) [2]")
    p.add_argument("-k", "--kmer", type=int, default=27, metavar="INT",
                   help="k-mer size (maximum: 28) [27]")
    p.add_argument("--fast", action="store_true",
                   help="enable 'fast mode' (skip all-zero-GT samples)")
    p.add_argument("--use-unique-kmers", action="store_true",
                   help="use only unique k-mers for indexing")
    p.add_argument("--seed", type=int, default=0,
                   help="deterministic seed for Bloom-filter hashing [0]")
    _add_device(p)
    p.add_argument("-t", "--threads", type=int, default=10, metavar="INT",
                   help="processes walking haplotype contexts [10]")
    p.add_argument("-D", "--debug", action="store_true")
    return p


def _add_genotype(sub):
    p = sub.add_parser(
        "genotype",
        help="Perform genotyping and phasing based on k-mer counting.",
    )
    p.add_argument("--load-graph", default="graph.vgt", metavar="FILE",
                   help="load Genome Graph index from file [graph.vgt]")
    p.add_argument("-s", "--samples", required=True, metavar="FILE",
                   help="samples configuration file: sample r1.fq.gz r2.fq.gz")
    p.add_argument("-g", "--genotype", default="het", choices=["hom", "het"],
                   help="sample genotype: hom or het [het]")
    p.add_argument("--sample-ploidy", type=int, default=2, metavar="INT",
                   help="sample ploidy (2-8) [2]")
    p.add_argument("-n", "--number", type=int, default=15, metavar="INT",
                   help="the haploid number for genotyping [15]")
    p.add_argument("--granularity", type=float, default=1.0, metavar="FLOAT",
                   help="chromosome window length per task (Mb) [1]")
    p.add_argument("-m", "--mode", default="rec", choices=["fre", "rec"],
                   help="transition probability: haplotype frequency (fre) or "
                        "recombination rate (rec) [rec]")
    p.add_argument("--sv", action="store_true",
                   help="structural variation genotyping only")
    p.add_argument("--min-support", type=float, default=0.0, metavar="FLOAT",
                   help="minimum site quality (GQ) for genotype [0]")
    p.add_argument("--use-depth", action="store_true",
                   help="use sequencing depth as the homozygous k-mer depth")
    p.add_argument("--seed", type=int, default=0,
                   help="deterministic seed for haplotype sampling [0]")
    p.add_argument("--engine", default="torch", choices=["torch", "np"],
                   help="genotyping engine: device (torch) or host oracle (np) "
                        "[torch]")
    _add_device(p)
    p.add_argument("--out-dir", default=".", metavar="DIR",
                   help="output directory for <sample>.varigraph.vcf.gz [.]")
    p.add_argument("--save-counts", default="", metavar="FILE",
                   help="save the counted-reads state after counting "
                        "(single-sample runs)")
    p.add_argument("--load-counts", default="", metavar="FILE",
                   help="load a counted-reads state and skip counting "
                        "(single-sample runs)")
    p.add_argument("-t", "--threads", type=int, default=10, metavar="INT",
                   help="FASTQ files read concurrently [10]")
    p.add_argument("-D", "--debug", action="store_true")
    p.add_argument("--batch-size", type=int, default=0, metavar="INT",
                   help="reads per device batch (0 = auto) [16384]")
    p.add_argument("--max-read-len", type=int, default=0, metavar="INT",
                   help="padded read length per device batch; longer reads "
                        "split with k-1 overlap (0 = auto) [160]")
    p.add_argument("--mesh-devices", type=int, default=0, metavar="INT",
                   help="devices in the counting mesh (0 = all local)")
    # several processes (torch.distributed on gloo)
    p.add_argument("--coordinator", default="", metavar="HOST:PORT",
                   help="multi-host coordinator address (default: autodetect)")
    p.add_argument("--num-processes", type=int, default=0, metavar="INT",
                   help="number of host processes (default: autodetect)")
    p.add_argument("--process-id", type=int, default=-1, metavar="INT",
                   help="this process's rank (default: autodetect)")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="varigraph-tpu-torch",
        description="Genotyping and phasing based on k-mer counting "
                    "(PyTorch/CUDA port).",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    _add_construct(sub)
    _add_genotype(sub)
    args = parser.parse_args(argv)

    if args.command is None:
        parser.print_help(sys.stderr)
        return 1

    log(f"You are now running varigraph-tpu-torch (v{__version__}).", func="main")
    log("Execution started ...", func="main")

    if args.command == "construct":
        _construct(args)
    else:
        _genotype(args)

    log("Done ...", func="main")
    sys.stderr.write(report("varigraph-tpu-torch") + "\n")
    return 0


def _construct(args) -> None:
    cfg = VarigraphConfig(
        ref_file=args.reference,
        vcf_file=args.vcf,
        output_graph_file=args.save_graph,
        vcf_ploidy=max(args.vcf_ploidy, 2),
        kmer_len=max(args.kmer, 5),
        fast_mode=args.fast,
        use_unique_kmers=args.use_unique_kmers,
        seed=args.seed,
        device=args.device,
        threads=max(args.threads, 1),
        debug=args.debug,
    )
    cfg.validate_construct()
    cfg.log_construct()

    from .index.build import construct_graph_index
    from .index.serialize import save_graph

    gi = construct_graph_index(cfg)
    save_graph(gi, cfg.output_graph_file)


def _genotype(args) -> None:
    cfg = VarigraphConfig(
        input_graph_file=args.load_graph,
        samples_config_file=args.samples,
        sample_type=args.genotype,
        sample_ploidy=max(args.sample_ploidy, 2),
        haploid_num=args.number,
        granularity_bp=int(args.granularity * 1e6),
        transition_pro_type=args.mode,
        sv_genotype_only=args.sv,
        min_supporting_gq=args.min_support,
        use_depth=args.use_depth,
        seed=args.seed,
        save_counts_file=args.save_counts,
        load_counts_file=args.load_counts,
        engine=args.engine,
        device=args.device,
        threads=max(args.threads, 1),
        debug=args.debug,
    )
    if args.batch_size > 0:
        cfg.read_batch_size = args.batch_size
    if args.max_read_len > 0:
        cfg.max_read_len = args.max_read_len
    cfg.mesh_devices = max(args.mesh_devices, 0)
    cfg.coordinator = args.coordinator
    cfg.num_processes = args.num_processes
    cfg.process_id = args.process_id
    cfg.validate_genotype()
    cfg.log_genotype()

    from .genotype.pipeline import run_genotype
    from .parallel import dist

    # flags, or torchrun's environment, ask for several processes
    if (cfg.coordinator or cfg.num_processes > 1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.initialize_distributed(
            coordinator=cfg.coordinator or None,
            num_processes=cfg.num_processes or None,
            process_id=cfg.process_id if cfg.process_id >= 0 else None,
        )
    try:
        run_genotype(cfg, out_dir=args.out_dir)
    finally:
        dist.shutdown_distributed()


def run() -> int:
    """Entry point with the reference's log-and-exit(1) error policy."""
    try:
        return main()
    except (ValueError, FileNotFoundError, OSError) as e:
        log(f"Error: {e}", func="main")
        return 1


if __name__ == "__main__":
    sys.exit(run())
