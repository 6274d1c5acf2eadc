"""eval_mfu: percent of the card's float32 peak that the model FLOPs of the
evaluations reach (gprfbench.work.eval_flops at each job's block sizes at
its start), over the part of the window after the profiler had stopped."""

from gprfbench.work import PEAKS


def read(ctx):
    w = ctx.window
    t0 = ctx.tracer.t_resume if ctx.tracer.t_resume is not None else w.t_start
    flops = sum(ctx.job_flops(j) * sum(1 for t in j.eval_times if t >= t0) for j in w.jobs)
    if not flops or w.t_end <= t0:
        return None
    return 100.0 * flops / (w.t_end - t0) / PEAKS["f32_flops"]
