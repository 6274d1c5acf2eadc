"""K1_roofline: percent of its roofline that K1 reached in the traced
window (gprfbench.work.roofline_share)."""

from gprfbench.work import roofline_share


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline_share("K1", ctx.window.kernel_calls, ctx.trace["kernels"])
