"""replica_restarts: replicas restarted after they diverged, per fit of the
window, from the ``counters.json`` of each job (the multistart driver's
``replica_restarts``).  None where no fit counts them."""

from gprfbench.program_spans import fit_counters


def read(ctx):
    fits = [c for c in fit_counters(ctx) if "replica_restarts" in c]
    if not fits:
        return None
    return sum(c["replica_restarts"] for c in fits) / len(fits)
