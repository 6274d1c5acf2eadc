"""pdtree_reblock_ms: host milliseconds an evaluation of the traced window
inside the seismic loss's ``pdtree_reblock`` spans: the PD-tree traversal
of every replica's points, the block counts and the padded layout.  None
where the program records no such span."""

from gprfbench.program_spans import per_eval_ms, summary


def read(ctx):
    s = summary(ctx)
    if s is None or "pdtree_reblock" not in s["span_n"]:
        return None
    return per_eval_ms(ctx, "pdtree_reblock")
