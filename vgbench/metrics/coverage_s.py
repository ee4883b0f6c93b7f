"""Seconds a sample spends in the coverage model (the program's coverage
phase), a mean over the traced window."""


def read(ctx):
    d = [s["phases"]["coverage"] for s in ctx.samples if "coverage" in s["phases"]]
    return sum(b - a for a, b in d) / len(d) if d else None
