"""launch_calls_per_eval: CUDA runtime calls that enqueue device work
(kernel, graph, copy and memset launches) per evaluation in the traced
window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["evals"] or not ctx.trace["enqueue_calls"]:
        return None
    return ctx.trace["enqueue_calls"] / ctx.trace["evals"]
