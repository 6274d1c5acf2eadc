"""gprf_torch.model.fused and gprf_torch.optim.lbfgs against gprf_tpu's
fused engine and scan-L-BFGS runner, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gprf_tpu.ops.pallas_mvn as pm
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import fused as jfused
from gprf_tpu.optim.device_lbfgs import make_scan_lbfgs_runner as j_runner
from gprf_tpu.partition.grid import Blocker, grid_centers
from gprf_torch.model import fused as tfused
from gprf_torch.ops import mvn
from gprf_torch.ops import split_mvn
from gprf_torch.optim.lbfgs import make_scan_lbfgs_runner
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _entry_problem():
    """The problem of __graft_entry__.entry(): n=96, 4 blocks, dy=5."""
    n, nblocks, dy = 96, 4, 5
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, dy))
    centers = np.asarray(grid_centers(nblocks))
    return dict(X0=X, Y=Y, centers=centers, edges=Blocker(centers).neighbors(), X_obs=X,
                obs_std=0.05, wfn=[1.0], dfn=[0.2, 0.2], noise_var=0.01)


def _grid_problem(seed, n, nblocks, dy, lscale):
    rng = np.random.default_rng(seed)
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + rng.standard_normal(SX.shape) * 0.02
    centers = np.asarray(grid_centers(nblocks))
    return dict(X0=X_obs, Y=rng.standard_normal((n, dy)), centers=centers,
                edges=Blocker(centers).neighbors(), X_obs=X_obs, obs_std=0.02, wfn=[1.0],
                dfn=[lscale, lscale], noise_var=0.01)


def _pair(p, **kw):
    """(gprf_tpu FusedGridGPRF, gprf_torch FusedGridGPRF) on one problem."""
    args = (p["X0"], p["Y"], p["centers"], p["edges"], p["X_obs"], p["obs_std"])
    jf = jfused.FusedGridGPRF(*args, JCov.create(p["wfn"], p["dfn"]), p["noise_var"], **kw)
    tf = tfused.FusedGridGPRF(*args, cov_from_numpy(p["wfn"], p["dfn"], **F64),
                              p["noise_var"], **F64)
    return jf, tf


def _assert_close(v, g, v_ref, g_ref):
    np.testing.assert_allclose(v, v_ref, rtol=1e-9)
    assert np.abs(g - g_ref).max() <= 1e-7 * np.abs(g_ref).max()


@pytest.mark.parametrize("pair_mode", ["schur", "schur_pallas"])
def test_entry_problem_loss_and_gradient_match_jax(monkeypatch, pair_mode):
    if pair_mode == "schur_pallas":  # gprf_tpu's Pallas leaves in interpret mode
        for name in ("batched_chol_inv_pallas", "batched_tri_inv_pallas"):
            orig = getattr(pm, name)
            monkeypatch.setattr(pm, name, lambda A, interpret=False, _f=orig: _f(A, True))
        orig_mvn = pm.batched_mvn_ll_pallas
        monkeypatch.setattr(pm, "batched_mvn_ll_pallas",
                            lambda K, Y, n, interpret=False: orig_mvn(K, Y, n, True))
    p = _entry_problem()
    jf, tf = _pair(p, pair_mode=pair_mode)
    assert tf.m == jf.m
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = (p["X0"] + rng.normal(size=p["X0"].shape) * 0.01).reshape(-1)
        _assert_close(*tf.value_and_grad(x), *jf.value_and_grad(x))


def test_forced_split_matches_jax(monkeypatch):
    """leaf 16 forces the Schur split in the unary, pair and backward paths."""
    leaves = []
    monkeypatch.setattr(split_mvn, "LEAF_CHOL", 16)
    monkeypatch.setattr(split_mvn, "LEAF_TRI", 16)
    monkeypatch.setattr(split_mvn, "mvn_max_m", lambda dy: 16)
    ops = mvn.Ops(chol_inv=lambda K: leaves.append(K.shape[-1]) or mvn.CholInv.apply(K),
                  mvn_ll=mvn.MvnLL.apply, tri_inv=mvn.TriInv.apply)
    p = _grid_problem(3, 200, 4, 4, 0.3)
    jf, tf = _pair(p)
    tf.ops = ops
    assert tf.m > 32
    x = p["X0"].reshape(-1)
    _assert_close(*tf.value_and_grad(x), *jf.value_and_grad(x))
    assert leaves and max(leaves) <= 16


@pytest.mark.parametrize("n,B,m", [(500, 9, 80), (4000, 900, 8), (300, 150, 4), (50, 3, 32)])
def test_assemble_layout_matches_jax(n, B, m):
    rng = np.random.default_rng(n)
    blocks = rng.integers(0, B, size=n)
    ja, jm, jo = jfused.assemble_layout(jnp.asarray(blocks, dtype=jnp.int32), B, m)
    ta, tm, to = tfused.assemble_layout(torch.as_tensor(blocks), B, m)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(to) == bool(jo)


def test_capacity_growth_matches_jax():
    p = _grid_problem(4, 120, 9, 5, 0.15)
    jf, tf = _pair(p)
    m0 = tf.m
    x = (p["X_obs"] * 0.05).reshape(-1)  # squash into one corner: blocks overflow
    assert not tf.check_capacity(x) and bool(tf.overflow_fn()(torch.as_tensor(x)))
    v_ref, g_ref = jf.value_and_grad(x)
    v, g = tf.value_and_grad(x)
    assert tf.m > m0 and tf.m == jf.m and tf.check_capacity(x)
    _assert_close(v, g, v_ref, g_ref)


@pytest.mark.parametrize("task,C0", [("cov", [[0.25]]), ("xcov", [[0.25]]),
                                     ("xcov", [[0.02, 1.2, 0.2, 0.3]])])
def test_tasks_cov_and_xcov_match_jax(task, C0):
    p = _grid_problem(5, 90, 4, 3, 0.25)
    args = (p["X0"], p["Y"], p["edges"], p["X_obs"], p["obs_std"])
    jf = jfused.FusedSyntheticGPRF(*args, JCov.create(p["wfn"], p["dfn"]), p["noise_var"],
                                   task=task, C0=np.asarray(C0), centers=p["centers"])
    tf = tfused.FusedSyntheticGPRF(*args, cov_from_numpy(p["wfn"], p["dfn"], **F64),
                                   p["noise_var"], task=task, C0=np.asarray(C0),
                                   centers=p["centers"], **F64)
    theta = tf.theta0()
    np.testing.assert_array_equal(theta, jf.theta0())
    theta = theta + np.random.default_rng(6).normal(size=theta.shape) * 0.01
    v_ref, g_ref = jax.value_and_grad(jf.loss_fn())(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    v = tf.loss_fn()(th)
    (g,) = torch.autograd.grad(v, th)
    _assert_close(float(v.detach()), g.numpy(), float(v_ref), np.asarray(g_ref))
    for a, b in zip(tf.unpack_host(theta), jf.unpack_host(theta)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(a, b, rtol=1e-15)
    assert bool(tf.overflow_fn()(th.detach())) == bool(jf.overflow_fn()(jnp.asarray(theta)))


def test_rpc_partition_is_not_ported_yet():
    p = _entry_problem()
    with pytest.raises(NotImplementedError):
        tfused.FusedSyntheticGPRF(p["X0"], p["Y"], p["edges"], p["X_obs"], 0.05,
                                  cov_from_numpy([1.0], [0.2, 0.2], **F64), 0.01,
                                  rpc_tree=object(), **F64)


def test_scan_lbfgs_trajectory_matches_jax():
    """2 dispatches of 5 steps from the same x0: per-step values, accepted
    flags and the overflow flag agree with gprf_tpu's runner."""
    p = _grid_problem(7, 120, 9, 4, 0.15)
    jf, tf = _pair(p)
    x0 = p["X0"].reshape(-1)
    j_init, j_run = j_runner(jf.loss_fn(), num_steps=5, aux_fn=jf.overflow_fn())
    t_init, t_run = make_scan_lbfgs_runner(tf.loss_fn(), num_steps=5, aux_fn=tf.overflow_fn())
    jc, tc = j_init(jnp.asarray(x0)), t_init(torch.as_tensor(x0))
    values = []
    for _ in range(2):
        jc, j_out = j_run(jc)
        tc, t_out = t_run(tc)
        np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]), rtol=1e-7)
        np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
        np.testing.assert_allclose(t_out[2].numpy(), np.asarray(j_out[2]), rtol=1e-6)
        assert bool(t_out[3]) == bool(j_out[3])
        values.append(t_out[0].numpy())
    np.testing.assert_allclose(tc["x"].numpy(), np.asarray(jc["x"]), rtol=1e-6, atol=1e-9)
    values = np.concatenate(values)
    assert values[-1] < values[0] and not bool(t_out[3])


def test_scan_lbfgs_solves_a_quadratic():
    A = torch.diag(torch.tensor([1.0, 10.0, 100.0], dtype=torch.float64))
    b = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    init_fn, run_fn = make_scan_lbfgs_runner(lambda x: 0.5 * x @ (A @ x) - b @ x, 40)
    carry, (values, accepted, gnorms) = run_fn(init_fn(torch.zeros(3, dtype=torch.float64)))
    np.testing.assert_allclose(carry["x_prev"].numpy(), [1.0, -0.2, 0.03], rtol=1e-6)
    assert values.shape == accepted.shape == gnorms.shape == (40,)
