"""Seconds a sample's scoring waits for window prep (the engine's
non-overlapped prep), a mean over the traced window."""


def read(ctx):
    d = [s["engine"]["prep"] for s in ctx.samples if "prep" in s["engine"]]
    return sum(d) / len(d) if d else None
