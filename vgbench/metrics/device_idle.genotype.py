"""Share of the traced window (%) in which no kernel, copy or set ran on the
card: 100 x (1 - busy / window), busy the union of the device intervals."""


def read(ctx):
    d = ctx.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
