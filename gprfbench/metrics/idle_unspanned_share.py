"""idle_unspanned_share: percent of the traced window's device-idle time
whose gap begins outside every program span but ``fit`` (the part of the
idle time that the program's spans do not name)."""

from gprfbench.program_spans import OUTSIDE, summary


def read(ctx):
    s = summary(ctx)
    if s is None or s["idle_s"] <= 0:
        return None
    return 100.0 * (s["idle_by_span"].get(OUTSIDE, 0.0)
                    + s["idle_by_span"].get("fit", 0.0)) / s["idle_s"]
