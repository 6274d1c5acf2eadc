"""Run one cell of the benchmark of ``gprf_torch`` once.

    python3 -m gprfbench.run --workload synth10k.device_fit --seed 7 --seconds 30 --trace 0

Set-up (counted in ``setup_s``, from the start of this process): the data
of ``--seed`` made on the card, and one short warm-up job at the cell's
shapes.  Then the measured window: whole fits back to back for
``--seconds`` (``jobs.py``), with ``torch.profiler`` from its second
dispatch for ``TRACE_SECONDS`` (``trace.py``) under ``--trace 1``.  Then,
with the program's state freed, the comparison with the plain reference
(``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (jobs), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit, which are also the
last lines of standard error.  Without a CUDA device, or with fewer than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every cache at a fixed path inside the checkout (the program's kernel
# library builds into gprf_torch/csrc/build/ by itself)
CACHE = CHECKOUT / ".gprfbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "gprf_tpu")
TRACE_SECONDS = 3.0
EXIT_NO_DEVICE, EXIT_FORBIDDEN = 3, 4


def forbidden_modules() -> list[str]:
    """Top-level names (before the first dot, whole) of loaded modules that
    the benchmark must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Forbidden(RuntimeError):
    pass


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_process: float,
             trace_seconds: float = TRACE_SECONDS, log=None) -> dict:
    """One run of ``cell`` on ``device``; the result object."""
    import torch

    from gprfbench import check, jobs, spec, trace
    from gprfbench import data as bdata
    from gprfbench import work

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device.type == "cuda"
    config = cell.config
    tmp = tempfile.mkdtemp(prefix="gprfbench-")
    try:
        problem = bdata.make_problem(cell, seed, device)
        engine = jobs.make_engine(cell, problem, device)
        engine.warm_up(tmp)
        tracer = trace.Tracer(traced, trace_seconds, device)
        tracer.warm()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.time() - t_process
        window = jobs.run_window(engine, problem, seconds, tracer, tmp)
        memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        found = forbidden_modules()
        if found:
            raise Forbidden("loaded once the window closed: " + ", ".join(found))
        t_reduce = time.perf_counter()
        summary = trace.reduce(tracer) if traced else None
        if traced:
            log("trace: stop %.3f s, reduction %.3f s" % (
                (tracer.t_resume or 0) - (tracer.t_stop or 0), time.perf_counter() - t_reduce))

        def job_flops(job):
            return work.eval_flops(problem.block_sizes(job.X_obs), problem.edges.tolist(),
                                   config["yd"], config["dx"])

        ctx = SimpleNamespace(cell=cell, problem=problem, window=window, trace=summary,
                              tracer=tracer, setup_s=setup_s, memory_peak_bytes=memory_peak,
                              cuda=cuda, job_flops=job_flops)
        wanted = cell.metrics_layer if traced else cell.metrics_e2e
        metrics = {}
        for m in wanted:
            value = spec.metric_reader(m.name, cell.bench_dir)(ctx)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
        for job in window.jobs:
            log("job %d: %d evaluations in %d dispatches, %.3f s (build %.3f, checkpoints "
                "%.3f, loop %.3f ms an evaluation), m %s, %s%s" % (
                    job.index, job.evals, job.dispatches, job.t_end - job.t_start, job.build_s,
                    job.ckpt_s, job.loop_s / max(job.evals, 1) * 1e3, job.m_end,
                    "completed" if job.completed else "cut by the window",
                    "" if job.error is None else ", FAILED " + job.error))
        log("window %.3f s, %d evaluations; set-up %.3f s" % (window.seconds, window.evals,
                                                              setup_s))
        log("attribution: " + json.dumps(window.attribution()))
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        per_job = []
        values = check.readings(problem, engine, window, per_job=per_job)
        ok, checks = check.judge(values, cell.limits)
        log("reference: %.3f s; per job: %s" % (time.perf_counter() - t_ref, json.dumps(per_job)))
        failed = sum(job.error is not None for job in window.jobs)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": memory_peak}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
        result = {"correct": bool(ok and failed == 0), "attempted": len(window.jobs),
                  "failed": failed, "metrics": metrics, "device": dev}
        if summary is not None:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from gprfbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("gprfbench: the cell needs %d CUDA device(s); torch.cuda.is_available() is %s, "
              "device_count() is %d" % (cell.chips, torch.cuda.is_available(),
                                        torch.cuda.device_count()), file=sys.stderr)
        return EXIT_NO_DEVICE
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_PROCESS)
    except Forbidden as exc:
        print("gprfbench: " + str(exc), file=sys.stderr)
        return EXIT_FORBIDDEN
    found = forbidden_modules()
    if found:
        print("gprfbench: loaded: " + ", ".join(found), file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
