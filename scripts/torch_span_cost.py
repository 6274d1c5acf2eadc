#!/usr/bin/env python3
"""The host cost of one span of ``gprf_torch.utils.profiling``, off (no
profiler recording: the shared null context) and on (a ``torch.profiler``
recording, CPU activity only), over many spans in a loop, less the loop's
own cost.

    python3 scripts/torch_span_cost.py [--off 1000000] [--on 100000] [--repeats 5]

Prints one JSON line: the median over ``--repeats`` of the nanoseconds a
span costs off and on, the loop's own nanoseconds, and the machine's CPU
and, where there is one, the card's name and power limit.  Needs no card.
"""

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _loop_ns(n):
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    return (time.perf_counter_ns() - t0) / n


def _spans_ns(span, n):
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("step"):
            pass
    return (time.perf_counter_ns() - t0) / n


def _card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from gprf_torch.utils import profiling

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--off", type=int, default=1_000_000)
    parser.add_argument("--on", type=int, default=100_000)
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)

    off, on, loop = [], [], []
    for _ in range(args.repeats):
        loop.append(_loop_ns(args.off))
        off.append(_spans_ns(profiling.span, args.off) - loop[-1])
        first = profiling.mark()
        with profile(activities=[ProfilerActivity.CPU]):
            on.append(_spans_ns(profiling.span, args.on) - _loop_ns(args.on))
        assert profiling.mark() - first == args.on
    print(json.dumps({"span_off_ns": statistics.median(off), "span_on_ns": statistics.median(on),
                      "loop_ns": statistics.median(loop), "spans_off": args.off,
                      "spans_on": args.on, "repeats": args.repeats,
                      "cpu": platform.processor() or platform.machine(), "card": _card()}))


if __name__ == "__main__":
    main()
