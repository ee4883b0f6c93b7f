"""Share (%) of its roofline that the forward/backward kernel (csrc/fb.cu)
reaches over the traced window: the sum of each launch's bound (bounds.py)
over the kernel's device seconds."""


def read(ctx):
    from vgbench.trace import kernel_seconds

    b = ctx.bounds and ctx.bounds.get("fb")
    t = kernel_seconds(ctx.device, "fb_kernel", "fb_wide_kernel") if ctx.device else 0.0
    return 100.0 * b / t if b and t > 0 else None
