"""The float64 refinement phase against gprf_tpu's, float64 on the CPU:
LINALG_OPS (the card's float64 route on ``torch.linalg``) against the
twins, refine_f64 against the reference's refine_f64 on the host from the
same point (log rows at rtol 1e-6, the same numbering, covs.txt), its cap,
its cadence past m = 512 and its stall rule, and ``--refine_iters`` through
the synthetic command line against the reference's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.cli import gprfopt as jcli
from gprf_tpu.data.sampled import SampledData as JSampled
from gprf_tpu.model import fused as jfused
from gprf_tpu.optim import device_lbfgs as jlbfgs
from gprf_tpu.partition.grid import grid_centers
from gprf_torch.cli import gprfopt as tcli
from gprf_torch.data.sampled import SampledData as TSampled
from gprf_torch.model import fused as tfused
from gprf_torch.ops import mvn, split_mvn
from gprf_torch.optim import lbfgs as tlbfgs
from gprf_torch.optim.driver import load_log

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt keeps two decimals
OPS_RTOL = 1e-10
TASKS = {"x": None, "cov": [[0.02, 1.2, 0.12, 0.2]], "xcov": [[0.12]]}


def _spd(B, m, n_active, seed):
    """Identity-padded SPD blocks [B, m, m] with the first n_active rows
    live, and right-hand sides [B, m, 3] zero on the padding."""
    g = np.random.default_rng(seed)
    A = g.standard_normal((B, m, m)) / np.sqrt(m)
    K = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    mask = (np.arange(m) < n_active).astype(float)
    K = K * mask[:, None] * mask[None, :] + np.diag(1.0 - mask)
    Y = g.standard_normal((B, m, 3)) * mask[:, None]
    return (torch.tensor(K, dtype=torch.float64), torch.tensor(Y, dtype=torch.float64),
            torch.full((B,), float(n_active), dtype=torch.float64))


def _value_and_grads(fn, inputs, seed=0):
    """A fixed random functional of fn's outputs, and its gradients."""
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    v = sum(torch.sum(torch.randn(o.shape, generator=g, dtype=o.dtype) * torch.tril(o)
                      if o.ndim == 3 and o.shape[-1] == o.shape[-2] else
                      torch.randn(o.shape, generator=g, dtype=o.dtype) * o) for o in outs)
    return [o.detach() for o in outs], torch.autograd.grad(v, inputs, allow_unused=True)


def _assert_close(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=OPS_RTOL,
                                   atol=OPS_RTOL * float(y.abs().max()))


# ---- LINALG_OPS ----------------------------------------------------------------


@pytest.mark.parametrize("op", ["chol_inv", "mvn_ll", "tri_inv", "mvn_ll_inv", "cholesky"])
def test_linalg_ops_match_the_twins_in_float64(op):
    K, Y, nact = _spd(3, 20, 17, seed=1)
    if op == "tri_inv":
        inputs = (mvn.cholesky_plain(K),)
    elif op in ("mvn_ll", "mvn_ll_inv"):
        inputs = (K, Y, nact)
    else:
        inputs = (K,)
    ours = _value_and_grads(getattr(mvn.LINALG_OPS, op), inputs)
    twins = _value_and_grads(getattr(mvn.PLAIN_OPS, op), inputs)
    _assert_close(ours[0], twins[0])
    _assert_close(ours[1], twins[1])


def test_linalg_ops_take_any_width_whole():
    """Leaves without caps: a composition past every kernel cap (m = 260)
    calls each leaf once at the full width, and equals the twins' split."""
    K, Y, nact = _spd(2, 260, 251, seed=2)
    calls = []

    def counted(name):
        def f(*a):
            calls.append((name, a[0].shape[-1]))
            return getattr(mvn.LINALG_OPS, name)(*a)
        return f

    ops = mvn.LINALG_OPS._replace(**{n: counted(n) for n in ("chol_inv", "mvn_ll", "tri_inv",
                                                             "cholesky")})
    assert not ops.leaf_caps and mvn.PLAIN_OPS.leaf_caps and mvn.KERNEL_OPS.leaf_caps
    for fn, args in ((split_mvn.chol_inv_split, (K,)), (split_mvn.tri_inv_split,
                                                        (mvn.cholesky_plain(K),)),
                     (split_mvn.cholesky_split, (K,)), (split_mvn.mvn_ll_split, (K, Y, nact))):
        calls.clear()
        ours = fn(*args, ops=ops)
        assert [w for _, w in calls] == [260], fn.__name__
        _assert_close(ours if isinstance(ours, tuple) else (ours,),
                      (lambda r: r if isinstance(r, tuple) else (r,))(
                          fn(*args, ops=mvn.PLAIN_OPS)))
    # a leaf given explicitly still splits
    calls.clear()
    split_mvn.chol_inv_split(K, leaf=136, ops=ops)
    assert sorted({w for _, w in calls}) == [124, 136]


def test_cholesky_checked_raises_on_a_finite_indefinite_block():
    K, _, _ = _spd(3, 12, 12, seed=3)
    bad = K.clone()
    bad[1, 4, 4] = -5.0
    with pytest.raises(torch.linalg.LinAlgError, match="not positive definite"):
        mvn.LINALG_OPS.chol_inv(bad)
    # a non-finite block gives NaN (the optimizer rejects the point), as the twins do
    nan = K.clone()
    nan[2, 0, 0] = float("nan")
    L = mvn.LINALG_OPS.cholesky(nan)
    assert torch.isnan(L[2]).any() and torch.isfinite(L[:2]).all()
    torch.testing.assert_close(L[:2], mvn.cholesky_plain(K)[:2], rtol=0, atol=0)


def test_kernel_wrappers_refuse_float64_where_they_launch():
    """On the CPU a wrapper takes its twin at any width; the CUDA float64
    refusal itself is a card test (tests/test_torch_cuda.py)."""
    K, _, _ = _spd(1, 8, 8, seed=4)
    with pytest.raises(TypeError, match="float32"):
        mvn._check("chol_inv", K, K.shape)
    torch.testing.assert_close(mvn.chol_inv(K)[0], mvn.cholesky_plain(K))


# ---- refine_f64 against the reference ------------------------------------------


@pytest.fixture(scope="module")
def data():
    """(port dataset, reference dataset): n 240, 9 grid blocks, dy 3."""
    kw = dict(n=260, ntrain=240, lscale=0.15, obs_std=0.02, yd=3, seed=5, noise_var=0.01)
    t, j = TSampled(**kw), JSampled(**kw)
    t.SY = j.SY.copy()
    for s in (t, j):
        s.set_centers(grid_centers(9))
    return t, j


def _makers(data, task, m=None, pair_chunk=None):
    t, j = data
    C0 = None if TASKS[task] is None else np.array(TASKS[task])
    anchor = t.SX if task == "cov" else t.X_obs
    args = (anchor, j.SY, t.neighbors, t.X_obs, t.obs_std)
    kw = dict(task=task, C0=C0, centers=np.asarray(t.centers), m=m)

    def make_t(dtype):
        return tfused.FusedSyntheticGPRF(*args, t.cov, t.noise_var, **kw, device="cpu",
                                         dtype=dtype, ops=mvn.LINALG_OPS, pair_chunk=pair_chunk)

    def make_j(dtype):
        return jfused.FusedSyntheticGPRF(*args, j.cov, j.noise_var, **kw, dtype=dtype)

    return make_t, make_j


def _rows(d, name="log.txt"):
    with open(os.path.join(d, name)) as f:
        return f.read().splitlines()


def _log(d):
    steps, _, values = load_log(d)
    return steps, values


@pytest.mark.parametrize("task", ["x", "cov", "xcov"])
def test_refine_f64_matches_jax(tmp_path, data, task, capsys):
    """Two dispatches of 5 steps from the same point, after a log whose
    rows end at step 6: rows 7-16, checkpoints at 11 and 16, covs.txt
    rows for the theta tasks, the closing line."""
    make_t, make_j = _makers(data, task)
    x0 = make_t(torch.float64).theta0()
    x0 = x0 + np.random.default_rng(1).standard_normal(x0.shape) * 1e-3
    dirs = []
    for name in ("torch", "jax"):
        d = tmp_path / name
        d.mkdir()
        (d / "log.txt").write_text("".join("%d 0.10 -1.00\n" % i for i in range(7))
                                   + "optimization finished after 0s\n")
        dirs.append(str(d))
    dt, dj = dirs
    kw = dict(iters=10, steps_per_dispatch=5)
    xt = tlbfgs.refine_f64(dt, make_t, x0, 7, **kw)
    assert "refine_f64: running the f64 tail on cpu" in capsys.readouterr().out
    xj = jlbfgs.refine_f64(dj, make_j, x0, 7, backend="cpu", **kw)
    (ts, tv), (js, jv) = _log(dt), _log(dj)
    assert list(ts) == list(js) == list(range(17))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    assert tv[7:].max() >= tv[7]
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=RTOL, atol=1e-9)
    assert xt.dtype == np.float64
    assert _rows(dt)[-1].startswith("f64 refinement finished after")
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    for name in os.listdir(dt):
        if name.endswith(".npy"):
            assert name[5:10] in ("00011", "00016")
            np.testing.assert_allclose(np.load(os.path.join(dt, name)),
                                       np.load(os.path.join(dj, name)), rtol=RTOL, atol=1e-9)
    assert os.path.exists(os.path.join(dt, "covs.txt")) == (task != "x")
    if task != "x":
        tc, jc = _rows(dt, "covs.txt"), _rows(dj, "covs.txt")
        assert [r.split()[0] for r in tc] == [r.split()[0] for r in jc] == ["11", "16"]


def test_refine_f64_skips_blocks_past_its_cap(tmp_path, data, capsys, monkeypatch):
    make_t, make_j = _makers(data, "x")
    m = make_t(torch.float64).m
    monkeypatch.setenv("GPRF_REFINE_MAX_M", str(m - 8))
    x0 = make_t(torch.float64).theta0()
    out = tlbfgs.refine_f64(str(tmp_path), make_t, x0, 3)
    ours = capsys.readouterr().out
    assert out is x0 or np.array_equal(out, x0)
    jlbfgs.refine_f64(str(tmp_path), make_j, x0, 3)
    assert ours == capsys.readouterr().out == (
        "refine_f64: block width m=%d exceeds the cap %d; skipping the f64 phase "
        "(raise GPRF_REFINE_MAX_M to force)\n" % (m, m - 8))
    assert os.listdir(tmp_path) == []


def test_refine_f64_takes_two_steps_a_dispatch_past_m_512(tmp_path, monkeypatch):
    kw = dict(n=50, ntrain=40, lscale=0.3, obs_std=0.02, yd=2, seed=5, noise_var=0.01)
    small = TSampled(**kw), JSampled(**kw)
    for s in small:
        s.set_centers(grid_centers(4))
    # one pair chunk of all the edges, where the default past m = 512 pads to 64
    make_t, _ = _makers(small, "x", m=520, pair_chunk=len(small[0].neighbors))
    monkeypatch.setenv("GPRF_REFINE_MAX_M", "1024")
    x0 = make_t(torch.float64).theta0()
    tlbfgs.refine_f64(str(tmp_path), make_t, x0, 0, iters=4)
    steps, values = _log(str(tmp_path))
    assert list(steps) == [0, 1, 2, 3] and np.isfinite(values).all()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npy")) == [
        "step_00001_X.npy", "step_00003_X.npy"]


class _Flat:
    """A fused-evaluator stand-in at its minimum: every step's value is 0."""

    m = 8
    device = torch.device("cpu")

    def loss_fn(self):
        return lambda x: torch.sum((x - 1.0) ** 2, dim=-1)

    def overflow_fn(self):
        return lambda x: torch.zeros(x.shape[:-1], dtype=torch.bool)

    def unpack_host(self, x):
        return x.reshape(-1, 2), None


def test_refine_f64_stops_after_two_stalled_dispatches(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_REFINE_MAXSEC", "600")
    x = tlbfgs.refine_f64(str(tmp_path), lambda dtype: _Flat(), np.ones(4), 0, iters=100,
                          steps_per_dispatch=3)
    steps, values = _log(str(tmp_path))
    # the first dispatch sets the best, the next two improve on it by nothing
    assert list(steps) == list(range(9)) and not values.any()
    np.testing.assert_array_equal(x, np.ones(4))


def test_refine_f64_stops_at_its_time_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_REFINE_MAXSEC", "-1")
    tlbfgs.refine_f64(str(tmp_path), lambda dtype: _Flat(), np.zeros(4), 5)
    assert _rows(str(tmp_path))[-1].startswith("f64 refinement finished after")
    assert len(_log(str(tmp_path))[0]) == 0


def test_refine_f64_runs_on_the_evaluators_device(tmp_path):
    with pytest.raises(ValueError, match="not on meta"):
        tlbfgs.refine_f64(str(tmp_path), lambda dtype: _Flat(), np.zeros(4), 0, device="meta")


# ---- through the command line --------------------------------------------------

SMALL = dict(lscale=0.1, n=450, ntrain=400, nblocks=9, yd=4, local_dist=0.1)


@pytest.fixture
def exp(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    monkeypatch.delenv("GPRF_SAMPLER", raising=False)
    return tmp_path


def _force_float64(monkeypatch):
    class Float64Fused(jfused.FusedSyntheticGPRF):
        def __init__(self, *args, dtype=None, **kw):
            super().__init__(*args, dtype=jnp.float64, **kw)

    monkeypatch.setattr(jfused, "FusedSyntheticGPRF", Float64Fused)


def jax_tail_from_the_last_accepted_point(monkeypatch):
    """The reference starts its float64 tail at the loop's pending
    proposal, the port at the loop's last accepted point (``x_prev`` of the
    saved optimizer state): start the reference's there too, so that both
    tails run from the same point."""
    real = jlbfgs.refine_f64

    def refine_f64(d, make_fused, x32, it0, **kw):
        with np.load(os.path.join(d, "optimizer_state.npz")) as z:
            return real(d, make_fused, z["x_prev"].astype(np.float64), it0, **kw)

    monkeypatch.setattr(jlbfgs, "refine_f64", refine_f64)


@pytest.mark.parametrize("task,extra", [("x", {}), ("xcov", {})])
def test_refine_iters_run_matches_jax(exp, monkeypatch, task, extra):
    """``do_run`` with 20 float32-loop iterations (float64 here) and 10 of
    the float64 tail: the log goes on from 20, results.txt scores every
    row, covs.txt goes on for the theta task."""
    _force_float64(monkeypatch)
    jax_tail_from_the_last_accepted_point(monkeypatch)
    dt, dj = exp / "torch_run", exp / "jax_run"
    dt.mkdir()
    dj.mkdir()
    args = dict(SMALL, engine="device", task=task, max_iters=20, refine_iters=10, **extra)
    tcli.do_run(str(dt), device="cpu", dtype=torch.float64, **args)
    jcli.do_run(str(dj), **args)
    (ts, tv), (js, jv) = _log(str(dt)), _log(str(dj))
    assert list(ts) == list(js) == list(range(30))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    # the tail starts at the loop's last accepted point, so its first row is
    # the loop's last, and from there its rows do not fall by more than the
    # runner's slack of 8 float32 eps
    assert abs(tv[20] - tv[19]) <= LOG_ATOL
    assert np.diff(tv[19:]).min() >= -(LOG_ATOL + 1e-6 * np.abs(tv).max())
    rows = _rows(str(dt))
    assert rows[20].startswith("optimization finished") and rows[-1].startswith(
        "f64 refinement finished")
    with open(os.path.join(dt, "results.txt")) as f:
        assert len(f.read().splitlines()) == 31
    if task == "xcov":
        tc = [r.split()[0] for r in _rows(str(dt), "covs.txt")]
        assert tc == [r.split()[0] for r in _rows(str(dj), "covs.txt")] and tc[-1] == "29"


@pytest.mark.parametrize("extra", [[], ["--multistart", "2"]])
def test_refine_iters_through_the_command_line_on_the_cpu(exp, capsys, extra):
    """The command line itself: a float32 loop (or the multistart loop,
    whose winner the tail starts from), then the float64 tail."""
    argv = ["--ntrain", "400", "--ntest", "50", "--nblocks", "9", "--lscale", "0.1",
            "--local_dist", "0.1", "--yd", "4", "--device", "cpu", "--engine", "device",
            "--max_iters", "20", "--refine_iters", "10"] + extra
    tcli.main(argv)
    assert "refine_f64: running the f64 tail on cpu" in capsys.readouterr().out
    d = tcli.exp_dir(tcli.build_parser().parse_args(argv))
    steps, values = _log(d)
    assert list(steps) == list(range(30)) and np.isfinite(values).all()
    assert "step_00029_X.npy" in os.listdir(d)
    assert ("multistart.txt" in os.listdir(d)) == bool(extra)
