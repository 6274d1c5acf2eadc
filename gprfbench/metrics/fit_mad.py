"""fit_mad: mean |X - SX| over coordinates at the final X of each job that
ended inside the window, averaged over those jobs."""


def read(ctx):
    done = [j for j in ctx.window.jobs if j.completed and j.x_final is not None]
    if not done:
        return None
    return sum(ctx.problem.mad(j.x_final) for j in done) / len(done)
