"""Genotype each sample again from the counts a ``--save-counts`` pass saved
in set-up, as the CLI's ``genotype --load-counts`` does: no counting, then
the coverage model, scoring and the VCF."""

from vgbench import genotype


def run(cell, seed, seconds, trace, device, layout, t_start):
    return genotype.window(cell, seed, seconds, trace, device, layout, t_start,
                           counts=True)
