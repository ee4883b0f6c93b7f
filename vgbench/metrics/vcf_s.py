"""Seconds a sample spends writing its VCF (the program's VCF phase), a
mean over the traced window."""


def read(ctx):
    d = [s["phases"]["vcf"] for s in ctx.samples if "vcf" in s["phases"]]
    return sum(b - a for a, b in d) / len(d) if d else None
