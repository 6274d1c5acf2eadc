"""update_host_ms: host milliseconds an evaluation of the traced window
inside the runner's ``update`` spans: a step's acceptance, memory fold,
two-loop recursion and next proposal, after its evaluation."""

from gprfbench.program_spans import per_eval_ms


def read(ctx):
    return per_eval_ms(ctx, "update")
