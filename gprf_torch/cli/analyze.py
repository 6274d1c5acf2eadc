"""Analysis command line: visualization and fleet generation (mirror of
``gprf_tpu/cli/analyze.py``).

    python -m gprf_torch.cli.analyze vis RUN_DIR [--sdata_file F] [--y_target K] [--no_movie]
    python -m gprf_torch.cli.analyze gen-runs [--out_dir D]

``vis`` renders a run directory's step checkpoints as scatter plots and a
movie; ``gen-runs`` writes the paper's suites as launcher scripts of
``python -m gprf_torch.cli.gprfopt``.  Host code only.
"""

from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser(description="gprf analysis")
    sub = parser.add_subparsers(dest="cmd")

    vis = sub.add_parser("vis", help="render step checkpoints of a run")
    vis.add_argument("run_dir")
    vis.add_argument("--sdata_file", default=None, help="pickled SampledData for coloring")
    vis.add_argument("--y_target", type=int, default=-1,
                     help="output dim to color by; -1 location error, -2 RPC blocks, -3 grid blocks")
    vis.add_argument("--seed", type=int, default=None)
    vis.add_argument("--blocksize", type=int, default=None)
    vis.add_argument("--highlight_block", type=int, default=None)
    vis.add_argument("--no_movie", action="store_true")

    gen = sub.add_parser("gen-runs", help="emit fleet launcher scripts")
    gen.add_argument("--out_dir", default=".")

    args = parser.parse_args(argv)
    if args.cmd == "vis":
        from gprf_torch.analysis.plots import vis_points

        sdata = None
        if args.sdata_file:
            with open(args.sdata_file, "rb") as f:
                sdata = pickle.load(f)
        written = vis_points(
            args.run_dir,
            sdata=sdata,
            y_target=args.y_target,
            seed=args.seed,
            blocksize=args.blocksize,
            highlight_block=args.highlight_block,
            make_movie=not args.no_movie,
        )
        print(f"wrote {len(written)} frames")
    elif args.cmd == "gen-runs":
        from gprf_torch.analysis.fleet import gen_runs

        gen_runs(out_dir=args.out_dir)
        print("wrote run_eighty.sh run_truegp.sh run_fitc.sh")
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
