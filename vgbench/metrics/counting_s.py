"""Seconds a sample spends counting its reads (the program's counting
phase: FASTQ feed and the counting kernel), a mean over the traced window."""


def read(ctx):
    if ctx.operation != "genotype_reads":
        return None
    d = [s["phases"]["counting"] for s in ctx.samples if "counting" in s["phases"]]
    return sum(b - a for a, b in d) / len(d) if d else None
