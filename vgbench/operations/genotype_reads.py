"""Genotype each sample from its gzip FASTQ files, as the CLI's
``genotype`` does: counting, the coverage model, scoring and the VCF."""

from vgbench import genotype


def run(cell, seed, seconds, trace, device, layout, t_start):
    return genotype.window(cell, seed, seconds, trace, device, layout, t_start,
                           counts=False)
