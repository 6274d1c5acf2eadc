"""device_busy_ms: kernel time per evaluation in the traced window (the
profiler's kernel events, without copies or memsets)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["evals"] or not ctx.trace["kernels"]:
        return None
    return sum(s for _, s in ctx.trace["kernels"]) / ctx.trace["evals"] * 1e3
