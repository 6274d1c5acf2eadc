"""accepted_share: percent of the window's L-BFGS steps whose point was
accepted (useful evaluations over attempts), from the ``counters.json``
that the program writes into each job's run directory:
100 x sum(steps_accepted) / sum(steps x replicas).
``accepted_share.device_bound`` is the same in the 80k cells."""

from gprfbench.program_spans import fit_counters


def read(ctx):
    fits = fit_counters(ctx)
    steps = sum(c["steps"] * c.get("replicas", 1) for c in fits)
    if not steps:
        return None
    return 100.0 * sum(c["steps_accepted"] for c in fits) / steps
