"""eval_ms: the window's wall time over the objective+gradient evaluations
done in it (one evaluation is one L-BFGS iteration, plus one at each
job's start and at each capacity growth).  ``eval_ms.device_bound`` is the
same quantity in the cells whose device is busy most of the window, an
end-to-end metric; ``eval_ms.host_bound`` the same in the cell whose host
sets the pace, a per-layer metric, since the host's pace drifts too far
between runs for a bound."""


def read(ctx):
    if not ctx.window.evals:
        return None
    return ctx.window.seconds / ctx.window.evals * 1e3
