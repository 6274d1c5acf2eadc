"""eval_host_ms: host milliseconds an evaluation of the traced window inside
the program's ``step`` and ``init_eval`` spans (one evaluation with what
the runner does after it, or a fit's first evaluation).  Where the host
runs ahead of the card this is the time to enqueue an evaluation; where it
waits inside full launch queues, the evaluation's whole time.
``eval_host_ms.device_bound`` is the same in the 80k cells."""

from gprfbench.program_spans import per_eval_ms


def read(ctx):
    return per_eval_ms(ctx, "step", "init_eval") or None
