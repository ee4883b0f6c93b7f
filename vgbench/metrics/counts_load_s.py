"""Seconds a sample spends loading its saved counts (the program's counting
phase when it reads a counts checkpoint), a mean over the traced window."""


def read(ctx):
    if ctx.operation != "genotype_counts":
        return None
    d = [s["phases"]["counting"] for s in ctx.samples if "counting" in s["phases"]]
    return sum(b - a for a, b in d) / len(d) if d else None
