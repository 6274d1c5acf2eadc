"""gprf_torch.cli.gprfopt and the results protocol against gprf_tpu, on the
CPU in float64 (the port's ``--device cpu``; ``do_run``'s ``dtype`` is
float64 here so that whole optimizations can be held to rtol 1e-6, the
command line's own float32 run is checked for its files and its
progress)."""

import argparse
import os

import numpy as np
import pytest
import torch

from gprf_tpu.analysis import results as jresults
from gprf_tpu.cli import gprfopt as jcli
from gprf_tpu.data.sampled import sample_data as j_sample_data
from gprf_tpu.model import fused as jfused
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.analysis import results as tresults
from gprf_torch.cli import gprfopt as tcli

torch.set_num_threads(1)
RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt and results.txt keep two decimals of the objective

# the acceptance command, at dy = 4 to keep the test quick
SMALL = dict(lscale=0.1, n=450, ntrain=400, nblocks=9, yd=4, local_dist=0.1)
SMALL_ARGV = ["--ntrain", "400", "--ntest", "50", "--nblocks", "9", "--lscale", "0.1",
              "--local_dist", "0.1", "--yd", "4", "--device", "cpu"]


@pytest.fixture
def exp(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    monkeypatch.delenv("GPRF_SAMPLER", raising=False)
    return tmp_path


@pytest.fixture
def few_scipy_iterations(monkeypatch):
    """Both packages call ``scipy.optimize.minimize`` with maxiter 200; the
    comparison reads the first 10 evaluations, so 12 iterations do."""
    import scipy.optimize

    real = scipy.optimize.minimize

    def minimize(*args, **kw):
        return real(*args, **{**kw, "options": {**kw.get("options", {}), "maxiter": 12}})

    monkeypatch.setattr(scipy.optimize, "minimize", minimize)


def _log(d):
    with open(os.path.join(d, "log.txt")) as f:
        rows = [line.split() for line in f if line[0].isdigit()]
    return np.array([int(r[0]) for r in rows]), np.array([float(r[2]) for r in rows])


def _force_float64(monkeypatch):
    """gprf_tpu's CLI builds its device engine at float32; the comparison
    needs both sides at float64."""
    import jax.numpy as jnp

    class Float64Fused(jfused.FusedSyntheticGPRF):
        def __init__(self, *args, dtype=None, **kw):
            super().__init__(*args, dtype=jnp.float64, **kw)

    monkeypatch.setattr(jfused, "FusedSyntheticGPRF", Float64Fused)


def _both_runs(exp, monkeypatch, engine, task, **kw):
    dt, dj = exp / "torch_run", exp / "jax_run"
    dt.mkdir()
    dj.mkdir()
    if engine == "device":
        _force_float64(monkeypatch)
    args = dict(SMALL, engine=engine, task=task, **kw)
    seconds = tcli.do_run(str(dt), device="cpu", dtype=torch.float64, **args)
    jcli.do_run(str(dj), **args)
    assert set(seconds) == {"sample_s", "fit_s", "analyze_s"}
    return str(dt), str(dj)


def _assert_same_results(dt, dj, rows):
    t, j = tresults.load_results(dt), jresults.load_results(dj)
    assert t.shape[1] == j.shape[1] == len(tresults.RESULT_COLS) and len(t) >= rows
    np.testing.assert_array_equal(t[:rows, 0], j[:rows, 0])
    np.testing.assert_allclose(t[:rows, 2], j[:rows, 2], rtol=RTOL, atol=LOG_ATOL)
    np.testing.assert_allclose(t[:rows, 3:], j[:rows, 3:], rtol=1e-5, atol=2e-8)
    with open(os.path.join(dt, "results.txt")) as f:
        t_true = f.readlines()[-1].split()
    with open(os.path.join(dj, "results.txt")) as f:
        j_true = f.readlines()[-1].split()
    assert t_true[:2] == j_true[:2] == ["trueX", "inf"] and len(t_true) == len(j_true) == 12
    np.testing.assert_allclose([float(v) for v in t_true[2:]], [float(v) for v in j_true[2:]],
                               rtol=RTOL, atol=LOG_ATOL)


@pytest.mark.parametrize("task", ["x", "xcov"])
def test_device_engine_run_matches_jax(exp, monkeypatch, task):
    dt, dj = _both_runs(exp, monkeypatch, "device", task, max_iters=40)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert list(ts) == list(js) == list(range(40))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    assert tv[-1] > tv[0]
    # the first and the last dispatch always leave a checkpoint (those between
    # ride a wall-clock cadence)
    wanted = {"log.txt", "step_00019_X.npy", "step_00039_X.npy", "optimizer_state.npz",
              "results.txt", "finished"} | ({"covs.txt", "step_00039_cov.npy"} if task == "xcov"
                                            else set())
    assert wanted <= set(os.listdir(dt)) and wanted <= set(os.listdir(dj))
    _assert_same_results(dt, dj, 40)
    final, true_row = tresults.load_final_results(dt)
    first = tresults.read_result_line(open(os.path.join(dt, "results.txt")).readline())
    assert final["mad"] < first["mad"] and np.isfinite(true_row["mll"])


@pytest.mark.parametrize("task,extra", [("x", {}), ("cov", {}), ("xcov", dict(init_seed=3)),
                                        ("x", dict(init_true=True)),
                                        ("cov", dict(init_seed=2))])
def test_host_engine_run_matches_jax(exp, monkeypatch, task, extra, few_scipy_iterations):
    dt, dj = _both_runs(exp, monkeypatch, "host", task, **extra)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    rows = min(10, len(ts))  # a run from the true latents converges in a few evaluations
    assert rows >= 3 and list(ts[:rows]) == list(js[:rows])
    np.testing.assert_allclose(tv[:rows], jv[:rows], rtol=RTOL, atol=LOG_ATOL)
    _assert_same_results(dt, dj, rows)
    for name in ("log.txt", "results.txt", "finished"):
        assert os.path.exists(os.path.join(dt, name))


def test_init_x_continues_from_a_checkpoint(exp, monkeypatch):
    first = exp / "first"
    first.mkdir()
    tcli.do_run(str(first), device="cpu", dtype=torch.float64, engine="device", task="x",
                max_iters=20, **SMALL)
    ckpt = str(first / "step_00019_X.npy")
    dt, dj = _both_runs(exp, monkeypatch, "device", "x", max_iters=20, init_x=ckpt)
    np.testing.assert_allclose(_log(dt)[1], _log(dj)[1], rtol=RTOL, atol=LOG_ATOL)
    assert _log(dt)[1][0] > _log(str(first))[1][0]
    with pytest.raises(ValueError):
        tcli.do_run(dt, device="cpu", task="cov", init_x=ckpt, **SMALL)
    np.save(str(exp / "wrong.npy"), np.zeros((3, 2)))
    with pytest.raises(ValueError):
        tcli.do_run(dt, device="cpu", task="x", init_x=str(exp / "wrong.npy"), **SMALL)


def test_analyze_run_matches_jax_on_one_run_directory(exp):
    """The port's run directory, analyzed by both packages."""
    d = exp / "run"
    d.mkdir()
    tcli.do_run(str(d), device="cpu", dtype=torch.float64, engine="device", task="xcov",
                max_iters=40, **SMALL)
    with open(d / "results.txt") as f:
        ours = f.read()
    jdata = j_sample_data(n=450, ntrain=400, lscale=0.1, obs_std=0.01, yd=4, seed=0,
                          centers=grid_centers(9), noise_var=0.01)
    jresults.analyze_run(str(d), jdata, local_dist=0.1, X0=jdata.X_obs)
    with open(d / "results.txt") as f:
        theirs = f.read()
    ours, theirs = ours.splitlines(), theirs.splitlines()
    assert len(ours) == len(theirs) == 41
    for a, b in zip(ours[:-1], theirs[:-1]):
        assert a == b  # the same checkpoints and log, the same metrics, to the printed digit
    np.testing.assert_allclose([float(v) for v in ours[-1].split()[2:]],
                               [float(v) for v in theirs[-1].split()[2:]], rtol=RTOL,
                               atol=LOG_ATOL)
    # --analyze: only the analysis, on what is there
    os.remove(d / "results.txt")
    tcli.do_run(str(d), device="cpu", dtype=torch.float64, engine="device", task="xcov",
                analyze_only=True, **SMALL)
    with open(d / "results.txt") as f:
        assert f.read().splitlines() == ours
    # --analyze --analyze_full: the same rows with the six predictive columns filled
    tcli.do_run(str(d), device="cpu", dtype=torch.float64, engine="device", task="xcov",
                analyze_only=True, analyze_full=True, **SMALL)
    with open(d / "results.txt") as f:
        full = f.read().splitlines()
    for a, b in zip(full, ours):
        assert a.split()[:6] == b.split()[:6] and set(b.split()[6:]) == {"0.0000"}
        assert all(float(v) != 0.0 for v in a.split()[6:])


def test_results_readers_match_jax(tmp_path):
    rows = ["0 0.10 -5.00 0.00000000 0.02000000 10.00000000 0.0000 0.0000 0.0000 0.0000 0.0000 "
            "0.0000",
            "1 0.20 -3.00 1.10000000 0.01000000 12.00000000 0.0000 0.0000 0.0000 0.0000 0.0000 "
            "0.0000",
            "trueX inf -1.00 0.0000 0.0000 11.0000 0.0000 0.0000 0.0000 0.0000 0.0000 0.0000"]
    (tmp_path / "results.txt").write_text("\n".join(rows) + "\n")
    d = str(tmp_path)
    np.testing.assert_array_equal(tresults.load_results(d), jresults.load_results(d))
    assert tresults.load_final_results(d) == jresults.load_final_results(d)
    assert tresults.read_result_line(rows[1]) == jresults.read_result_line(rows[1])
    assert tresults.RESULT_COLS == jresults.RESULT_COLS
    v = [3.0, 1.0, 4.0, 1.0, 5.0]
    np.testing.assert_array_equal(tresults.max_history(v), jresults.max_history(v))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_command_line_on_the_cpu_writes_a_whole_run(exp, capsys, engine):
    """The command line itself (float32, as on the card) with either engine."""
    seconds = tcli.main(SMALL_ARGV + ["--task", "x", "--engine", engine, "--max_iters", "40",
                                      "--maxsec", "20"])
    out = capsys.readouterr().out
    name = "400_450_9_0.100000_0.010000_0.1000_4_l-bfgs-b_x_-1_0.0100_s0_gprf0"
    assert f"experiment dir: {exp / name}" in out and seconds["fit_s"] > 0
    files = os.listdir(exp / name)
    assert {"log.txt", "results.txt", "finished"} <= set(files)
    assert any(f.startswith("step_") and f.endswith("_X.npy") for f in files)
    assert ("optimizer_state.npz" in files) == (engine == "device")
    assert os.listdir(exp / "synthetic_datasets") == ["450_400_0.100000_0.010000_4_0.npz"]
    steps, values = _log(str(exp / name))
    assert len(steps) >= 10 and np.isfinite(values).all() and values.max() > values[0]
    final, true_row = tresults.load_final_results(str(exp / name))
    assert np.isfinite(true_row["mll"]) and final["mad"] < 0.0126  # X_obs starts at ~0.0125


@pytest.mark.parametrize("engine,task,extra", [
    ("host", "x", {}), ("device", "x", dict(max_iters=20)),
    ("device", "x", dict(max_iters=10, multistart=2)), ("device", "cov", dict(max_iters=10)),
    ("device", "xcov", dict(max_iters=10))])
def test_rpc_run_matches_jax(exp, monkeypatch, few_scipy_iterations, engine, task, extra):
    """An RPC partition (400 points at block size 60: 8 blocks of 50) on
    either engine: the host engine replays the splits on the host, the
    device engine on the device."""
    args = {k: v for k, v in SMALL.items() if k != "nblocks"}
    dt, dj = _both_runs(exp, monkeypatch, engine, task, rpc_blocksize=60, nblocks=1, **args,
                        **extra)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    rows = min(10, len(ts))
    assert rows >= 3 and list(ts[:rows]) == list(js[:rows])
    np.testing.assert_allclose(tv[:rows], jv[:rows], rtol=RTOL, atol=LOG_ATOL)
    assert tv[:rows].max() > tv[0]
    _assert_same_results(dt, dj, rows)
    if "multistart" in extra:
        assert os.path.exists(os.path.join(dt, "multistart.txt"))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_analyze_full_run_matches_jax(exp, monkeypatch, few_scipy_iterations, engine):
    """--analyze_full: results.txt's six predictive columns, logged values
    held at rtol 1e-6 (and one printed unit)."""
    dt, dj = _both_runs(exp, monkeypatch, engine, "x", analyze_full=True, max_iters=20)
    t, j = tresults.load_results(dt), tresults.load_results(dj)
    rows = min(10, len(t))
    np.testing.assert_allclose(t[:rows, 6:], j[:rows, 6:], rtol=RTOL, atol=1.1e-4)
    with open(os.path.join(dt, "results.txt")) as f:
        t_true = [float(v) for v in f.readlines()[-1].split()[6:]]
    with open(os.path.join(dj, "results.txt")) as f:
        j_true = [float(v) for v in f.readlines()[-1].split()[6:]]
    np.testing.assert_allclose(t_true, j_true, rtol=RTOL, atol=1.1e-4)
    assert all(v != 0.0 for v in t_true) and 0 < t_true[1] < 1  # SMSE below the mean's


FLAG_SETS = [
    [],
    ["--obs_std", "0.02", "--local_dist", "0.1", "--task", "xcov"],
    ["--init_true", "--seed", "3", "--yd", "10"],
    ["--init_seed", "4", "--noise_var", "0.02", "--method", "bfgs"],
    ["--rpc_blocksize", "200", "--gplvm_type", "sparse", "--num_inducing", "50"],
    ["--nblocks", "100", "--ntest", "0", "--local_dist", "1.0"],
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_build_run_name_matches_jax(flags):
    argv = ["--ntrain", "1000", "--nblocks", "16", "--lscale", "0.06"] + flags
    ta, ja = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    assert tcli.build_run_name(ta) == jcli.build_run_name(ja)
    as_dict = {k: v for k, v in vars(ja).items() if k in (
        "ntrain", "ntest", "nblocks", "lscale", "obs_std", "local_dist", "task", "seed")}
    assert tcli.build_run_name(as_dict) == jcli.build_run_name(dict(as_dict))


@pytest.mark.parametrize("extra", [[], ["--init_x", "/some/step_00399_X.npy"]])
def test_exp_dir_matches_jax(exp, extra):
    argv = ["--ntrain", "300", "--ntest", "30", "--nblocks", "4", "--lscale", "0.2"] + extra
    t = tcli.exp_dir(tcli.build_parser().parse_args(argv))
    j = jcli.exp_dir(jcli.build_parser().parse_args(argv))
    assert t == j and os.path.isdir(t) and t.startswith(str(exp))


def test_parser_has_the_references_flags_and_device():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices and tuple(a.choices))
                for a in parser._actions if not isinstance(a, argparse._HelpAction)}

    t, j = options(tcli.build_parser()), options(jcli.build_parser())
    assert t.pop("device") == (("--device",), "cuda", str, None)
    assert t == j


@pytest.mark.parametrize("flags,error", [
    (["--gplvm_type", "sparse", "--engine", "device"], ValueError),
    (["--multistart", "4", "--engine", "device", "--gplvm_type", "bayesian"], ValueError),
    (["--gplvm_type", "fitc", "--num_inducing", "10"], ValueError),
    (["--schur_precision", "high"], ValueError),
])
def test_refused_flags_raise_before_anything_runs(exp, flags, error):
    """What no engine serves: a GPLVM baseline on the device engine (the
    reference's do_run raises the same), an unknown baseline, the coarser
    Schur precision."""
    with pytest.raises(error):
        tcli.main(SMALL_ARGV + flags)
    assert os.listdir(exp) == []
    assert tcli.build_parser().parse_args(SMALL_ARGV + ["--schur_precision", "highest"])


def test_do_run_refuses_what_the_command_line_refuses(exp):
    for option in (dict(gplvm_type="bayesian", engine="device"), dict(gplvm_type="fitc")):
        with pytest.raises(ValueError, match="gplvm_type|GPLVM"):
            tcli.do_run(str(exp), device="cpu", **SMALL, **option)
    with pytest.raises(ValueError):
        tcli.do_run(str(exp), device="cpu", task="y", **SMALL)
    with pytest.raises(ValueError, match="GPLVM baselines use the host engine"):
        jcli.do_run(str(exp), engine="device", gplvm_type="sparse", **SMALL)
