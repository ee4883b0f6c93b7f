"""Seconds a sample's scoring waits for the posterior (the engine's
non-overlapped posterior), a mean over the traced window."""


def read(ctx):
    d = [s["engine"]["posterior"] for s in ctx.samples if "posterior" in s["engine"]]
    return sum(d) / len(d) if d else None
