"""Share (%) of its roofline that the emissions kernel (csrc/emit.cu)
reaches over the traced window: the sum of each launch's bound (bounds.py,
from the launch's own arguments) over the kernel's device seconds."""


def read(ctx):
    from vgbench.trace import kernel_seconds

    b = ctx.bounds and ctx.bounds.get("emissions")
    t = kernel_seconds(ctx.device, "emissions_kernel") if ctx.device else 0.0
    return 100.0 * b / t if b and t > 0 else None
