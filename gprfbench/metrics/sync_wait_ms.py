"""sync_wait_ms: host milliseconds an evaluation of the traced window
inside the drivers' ``sync`` spans, the reads of the card's results (once a
dispatch, and at checkpoints), where the host waits for the card to
drain.  ``sync_wait_ms.device_bound`` is the same in the 80k cells."""

from gprfbench.program_spans import per_eval_ms


def read(ctx):
    return per_eval_ms(ctx, "sync")
