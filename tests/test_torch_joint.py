"""The joint-form objective (the reference's parity oracle) and pair
chunking in gprf_torch against gprf_tpu, float64 on the CPU: gprf_ll and
gprf_value_and_grad, GPRF(form="joint"), the fused grid objective in both
pair modes, the GPCov helpers, and every chunked path against the same call
unchunked."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.kernels import gpcov as jgpcov
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import fused as jfused
from gprf_tpu.model import gprf as jgprf
from gprf_tpu.model import objective as jobj
from gprf_tpu.partition.grid import Blocker, grid_centers
from gprf_torch.kernels import gpcov as tgpcov
from gprf_torch.model import fused as tfused
from gprf_torch.model import gprf as tgprf
from gprf_torch.model import objective as tobj
from gprf_torch.model.fused_seismic import FusedSeismicGPRF
from gprf_torch.utils.convert import cov_from_numpy, params_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6  # against gprf_tpu: both float64, sums in another order
CHUNK_RTOL = 1e-12  # a chunked call against the same call unchunked


def _close(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300), np.abs(a - b).max()


# (n, grid blocks, dy, diagonal edges, weight function): m <= 24
PROBLEMS = [(60, 9, 3, True, "se"), (48, 4, 2, False, "matern32")]


def _problem(n, nblocks, dy, diag, wfn, seed=0):
    """(X, Y, reference GPRF, its layout arrays as numpy)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, dy))
    b = Blocker(grid_centers(nblocks))
    cov = JCov.create([1.3], [0.25, 0.2], wfn_str=wfn)
    g = jgprf.GPRF(X, Y, None, cov, 0.01, block_idxs=b.block_clusters(X),
                   neighbors=b.neighbors(diag_connections=diag))
    return X, Y, g, {k: np.asarray(v) for k, v in g.layout.device_arrays().items()}


def _joint_args(arrays, names=("assignment", "mask", "pair_assignment", "pair_mask",
                               "unary_weights", "pair_weights")):
    return [torch.as_tensor(np.array(arrays[k])) for k in names]


def _torch_params(X, g):
    return params_from_numpy(X, np.asarray(g.cov.wfn_params), np.asarray(g.cov.dfn_params),
                             g.noise_var, **F64)


def _jax_params(X, g):
    return jobj.GPRFParams(X=jnp.asarray(X), wfn_params=jnp.asarray(g.cov.wfn_params),
                           dfn_params=jnp.asarray(g.cov.dfn_params),
                           noise_var=jnp.asarray(g.noise_var))


@pytest.mark.parametrize("chunks", [(None, None), (2, 3)], ids=["whole", "chunked"])
@pytest.mark.parametrize("problem", PROBLEMS, ids=["se9", "matern4"])
def test_gprf_value_and_grad_matches_jax(problem, chunks):
    X, Y, g, arrays = _problem(*problem)
    wfn = problem[-1]
    ref = jobj.gprf_value_and_grad(_jax_params(X, g), jnp.asarray(Y),
                                   *[jnp.asarray(a) for a in _joint_args(arrays)],
                                   wfn_str=wfn, grad_cov=True, unary_chunk=chunks[0],
                                   pair_chunk=chunks[1])
    got = tobj.gprf_value_and_grad(_torch_params(X, g), torch.as_tensor(Y),
                                   *_joint_args(arrays), wfn_str=wfn, grad_cov=True,
                                   unary_chunk=chunks[0], pair_chunk=chunks[1])
    for a, b in zip(got, ref):
        _close(a, b, RTOL)
    ll = tobj.gprf_ll(_torch_params(X, g), torch.as_tensor(Y), *_joint_args(arrays),
                      wfn_str=wfn, unary_chunk=chunks[0], pair_chunk=chunks[1])
    _close(ll, ref[0], RTOL)


@pytest.mark.parametrize("problem", PROBLEMS, ids=["se9", "matern4"])
def test_joint_form_matches_the_schur_form(problem):
    """The 2m-wide joint factorization against the Schur split of the port
    itself, in float64 (the reference holds its own pair at 1e-12 / 1e-9)."""
    X, Y, g, arrays = _problem(*problem)
    wfn = problem[-1]
    p, Yt = _torch_params(X, g), torch.as_tensor(Y)
    joint = tobj.gprf_value_and_grad(p, Yt, *_joint_args(arrays), wfn_str=wfn, grad_cov=True)
    schur = tobj.gprf_value_and_grad_schur(
        p, Yt, *_joint_args(arrays, ("assignment", "mask", "edges", "unary_weights",
                                     "pair_weights")), wfn_str=wfn, grad_cov=True)
    _close(joint[0], schur[0], 1e-10)
    _close(joint[1], schur[1], 1e-8)
    _close(joint[2], schur[2], 1e-8)


@pytest.fixture(scope="module")
def model_pair():
    """(port GPRF, reference GPRF) in the joint form on one grid problem."""
    X, Y, g, _ = _problem(60, 9, 3, True, "se", seed=1)
    block_idxs = g.layout.block_idxs()
    jg = jgprf.GPRF(X, Y, None, g.cov, 0.01, block_idxs=block_idxs, neighbors=g.neighbors,
                    form="joint")
    tg = tgprf.GPRF(X, Y, None, cov_from_numpy([1.3], [0.25, 0.2], **F64), 0.01,
                    block_idxs=block_idxs, neighbors=g.neighbors, form="joint", **F64)
    return tg, jg


@pytest.mark.parametrize("local", [True, False], ids=["local", "all_pairs"])
def test_gprf_joint_llgrad_matches_jax(model_pair, local):
    tg, jg = model_pair
    got = tg.llgrad(grad_X=True, grad_cov=True, local=local)
    ref = jg.llgrad(grad_X=True, grad_cov=True, local=local)
    for a, b in zip(got, ref):
        _close(a, b, RTOL)
    schur = tgprf.GPRF(tg.X, tg.Y, None, tg.cov, tg.noise_var, block_idxs=tg.block_idxs,
                       neighbors=tg.neighbors, **F64)
    _close(got[0], schur.llgrad(local=local)[0], 1e-10)


@pytest.mark.parametrize("pair_mode", ["schur", "joint"])
def test_fused_grid_value_and_grad_matches_jax(pair_mode):
    rng = np.random.default_rng(5)
    n, dy = 72, 3
    X = rng.uniform(size=(n, 2))
    Y = rng.normal(size=(n, dy))
    centers = np.asarray(grid_centers(9))
    edges = np.asarray(Blocker(centers).neighbors(), dtype=np.int64)
    counts = np.bincount(edges.reshape(-1), minlength=9)
    uw = 1.0 - counts
    X_obs = X + rng.normal(size=X.shape) * 0.02
    m = 16
    jp = jobj.GPRFParams(X=jnp.asarray(X), wfn_params=jnp.asarray([1.2]),
                         dfn_params=jnp.asarray([0.3, 0.25]), noise_var=jnp.asarray(0.02))
    ref = jfused.fused_grid_value_and_grad(
        jp, jnp.asarray(Y), jnp.asarray(centers), jnp.asarray(edges, dtype=jnp.int32),
        jnp.asarray(uw), jnp.asarray(X_obs.reshape(-1)), 0.02, m=m, grad_cov=True,
        pair_mode=pair_mode)
    tp = params_from_numpy(X, [1.2], [0.3, 0.25], 0.02, **F64)
    got = tfused.fused_grid_value_and_grad(
        tp, torch.as_tensor(Y), torch.as_tensor(centers), torch.as_tensor(edges),
        torch.as_tensor(uw), torch.as_tensor(X_obs.reshape(-1)), 0.02, m=m, grad_cov=True,
        pair_mode=pair_mode)
    assert bool(got[3]) == bool(ref[3])
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b, RTOL)


def test_fused_grid_gprf_refuses_the_joint_form():
    p = dict(X0=np.zeros((8, 2)), Y=np.zeros((8, 1)), centers=np.asarray(grid_centers(4)),
             edges=[], X_obs=np.zeros((8, 2)), obs_std=0.1)
    cov = cov_from_numpy([1.0], [0.2, 0.2], **F64)
    with pytest.raises(ValueError, match="pair_mode"):
        tfused.FusedGridGPRF(*p.values(), cov, 0.01, pair_mode="joint", **F64)
    with pytest.raises(ValueError):
        jfused.FusedGridGPRF(*p.values(), JCov.create([1.0], [0.2, 0.2]), 0.01,
                             pair_mode="joint")


def test_gpcov_helpers_match_jax():
    row = np.array([0.03, 1.7, 0.2, 0.4])
    tcov, tnv = tgpcov.full_cov_to_gpcov(torch.as_tensor(row), wfn_str="matern32")
    jcov, jnv = jgpcov.full_cov_to_gpcov(jnp.asarray(row), wfn_str="matern32")
    assert (tcov.dfn_str, tcov.wfn_str) == (jcov.dfn_str, jcov.wfn_str)
    assert float(tnv) == float(jnv) and float(tcov.signal_var) == float(jcov.signal_var)
    assert tcov.n_params == jcov.n_params == 4
    np.testing.assert_array_equal(tgpcov.gpcov_to_full_cov(tcov, tnv).numpy(),
                                  np.asarray(jgpcov.gpcov_to_full_cov(jcov, jnv)))
    np.testing.assert_array_equal(tgpcov.gpcov_to_full_cov(tcov, tnv).numpy(), row[None])
    moved = tcov.with_params(dfn_params=[0.5, 0.6])
    np.testing.assert_array_equal(moved.dfn_params.numpy(),
                                  np.asarray(jcov.with_params(dfn_params=[0.5, 0.6]).dfn_params))
    assert moved.wfn_params is tcov.wfn_params and moved.dfn_params.dtype == torch.float64


# ---- chunking ---------------------------------------------------------------------


def test_schur_ll_pair_chunk_equals_unchunked():
    """pair_chunk=3 pads the edges with zero-weight (0, 0) dummies to whole
    chunks and remats each: the value and every gradient of the unchunked
    call, at two replicas."""
    X, Y, g, arrays = _problem(60, 9, 3, True, "se")
    a = {k: torch.as_tensor(np.array(v)) for k, v in arrays.items()}
    assert a["edges"].shape[0] % 3 != 0  # the padding is exercised
    rng = np.random.default_rng(2)
    Xs = np.stack([X, X + rng.normal(size=X.shape) * 0.01])
    out = []
    for chunk in (None, 3):
        p = tobj.GPRFParams(*(torch.tensor(v, dtype=torch.float64, requires_grad=True)
                              for v in (Xs, [[1.3], [1.1]], [[0.25, 0.2], [0.3, 0.2]],
                                        [0.01, 0.02])))
        cov = tgpcov.GPCov(wfn_params=p.wfn_params, dfn_params=p.dfn_params)
        two = torch.stack([a["assignment"], a["assignment"]])
        ll = tobj._schur_ll(p.X, torch.as_tensor(Y), two, torch.stack([a["mask"]] * 2),
                            a["edges"], a["unary_weights"], a["pair_weights"], cov, p.noise_var,
                            pair_chunk=chunk)
        out.append([ll.detach()] + list(torch.autograd.grad(ll.sum(), list(p))))
    for c, u in zip(*out):
        _close(u, c, CHUNK_RTOL)


def _fused_problem(m=None, **kw):
    rng = np.random.default_rng(7)
    n, dy = 90, 3
    X = rng.uniform(size=(n, 2))
    centers = np.asarray(grid_centers(9))
    return tfused.FusedSyntheticGPRF(
        X, rng.normal(size=(n, dy)), Blocker(centers).neighbors(diag_connections=True), X, 0.02,
        cov_from_numpy([1.0], [0.25, 0.25], **F64), 0.01, task="xcov", C0=[[0.3]],
        centers=centers, m=m, **F64, **kw)


def test_fused_synthetic_pair_chunk_equals_unchunked():
    out = []
    for chunk in (None, 3):
        fused = _fused_problem(pair_chunk=chunk)
        assert fused.loss_pair_chunk() == chunk
        theta = torch.as_tensor(fused.theta0()).requires_grad_(True)
        v = fused.loss_fn()(theta)
        out.append((v.detach(), torch.autograd.grad(v, theta)[0]))
    for c, u in zip(*out):
        _close(u, c, CHUNK_RTOL)


def test_fused_synthetic_picks_64_past_m_512():
    """On the CPU the reference's wide-m rule: 64 edges past m = 512, else
    none, at any R; a given pair_chunk wins."""
    assert _fused_problem().loss_pair_chunk() is None
    fused = _fused_problem(m=512)
    assert fused.loss_pair_chunk() is None
    fused.grow_capacity()
    assert fused.m == 528 and fused.loss_pair_chunk() == fused.loss_pair_chunk(4) == 64
    assert _fused_problem(m=520, pair_chunk=5).loss_pair_chunk(4) == 5


GB = 10**9


# (E, R, m, itemsize, budget bytes, chunk): the 80k shapes against half an
# 80 GB card, and the CPU's rule (no budget)
@pytest.mark.parametrize("E,R,m,itemsize,budget,chunk", [
    (342, 1, 896, 4, 40 * GB, None),  # 15.4 GB fits: the whole pass
    (342, 4, 896, 4, 40 * GB, 171),  # 61.5 GB: two equal chunks, no dummy
    (343, 4, 896, 4, 40 * GB, 172),  # one dummy edge, fewer than the 2 chunks
    (342, 1, 896, 8, 20 * GB, 171),  # float64 doubles the 15.4 GB
    (342, 1, 896, 4, 20 * GB, None),  # ... which float32 fits
    (342, 8, 896, 4, 40 * GB, 86),  # 123 GB: 4 chunks of 86, 2 dummy edges
    (0, 4, 896, 4, 40 * GB, None),  # no edges (Local)
    (342, 1, 520, 4, None, 64),  # the CPU: the reference's 64 past m = 512
    (342, 4, 512, 8, None, None),
])
def test_auto_pair_chunk(E, R, m, itemsize, budget, chunk):
    assert tobj.auto_pair_chunk(E, R, m, itemsize, budget) == chunk
    if chunk is None or budget is None:
        return
    nch = -(-E // chunk)
    need = R * E * tobj.PAIR_BUFFERS * m * m * itemsize
    # equal chunks that each fit, with fewer dummy edges than chunks
    assert R * chunk * tobj.PAIR_BUFFERS * m * m * itemsize <= budget < need
    assert 0 <= nch * chunk - E < -(-need // budget)


def test_auto_pair_chunk_scales_with_replicas_and_itemsize():
    for E, m in ((342, 896), (342, 640), (1000, 888), (5, 2000)):
        for budget in (GB, 20 * GB, 40 * GB):
            assert (tobj.auto_pair_chunk(E, 2, m, 4, budget)
                    == tobj.auto_pair_chunk(E, 1, m, 8, budget))
            assert (tobj.auto_pair_chunk(E, 4, m, 4, budget)
                    == tobj.auto_pair_chunk(E, 1, m, 4, budget // 4))


def test_fused_synthetic_chooses_the_chunk_from_each_calls_replicas(monkeypatch):
    """Against a budget (the card's half), the loss takes the whole pass
    where R's need fits, and equal chunks where it does not; the value is
    the whole pass's and the counters show the path."""
    from gprf_torch.utils import profiling

    fused = _fused_problem()
    E, m = fused.edges.shape[0], fused.m
    one = E * tobj.PAIR_BUFFERS * m * m * 8
    monkeypatch.setattr(tfused, "pair_budget_bytes", lambda device: 2 * one)
    assert fused.loss_pair_chunk(1) is None and fused.loss_pair_chunk(2) is None
    assert fused.loss_pair_chunk(3) == -(-E // 2)
    theta = torch.as_tensor(np.stack([fused.theta0()] * 3))
    loss = fused.loss_fn()
    profiling.fit_counts.update(pair_passes=0, pair_chunks=0, pair_dummy_edges=0,
                                pair_schur_blocked=0)
    chunked = loss(theta)
    whole = torch.stack([loss(t) for t in theta])
    assert profiling.fit_counts["pair_passes"] == 4
    assert profiling.fit_counts["pair_chunks"] == 2 + 3
    assert profiling.fit_counts["pair_dummy_edges"] == 2 * -(-E // 2) - E
    assert profiling.fit_counts["pair_schur_blocked"] == 0  # m under K2's leaf: S whole
    _close(chunked, whole, CHUNK_RTOL)


@pytest.mark.parametrize("form", ["schur", "joint"])
def test_gprf_forced_budget_equals_unchunked(monkeypatch, form):
    """A budget of a few KB makes _auto_chunk chunk both batches (at its
    floor of 8 items, as at the 80k shapes) in both forms."""
    X, Y, g, _ = _problem(200, 9, 3, True, "se", seed=4)
    kw = dict(block_idxs=g.layout.block_idxs(), neighbors=g.neighbors, form=form, **F64)
    cov = cov_from_numpy([1.3], [0.25, 0.2], **F64)
    whole = tgprf.GPRF(X, Y, None, cov, 0.01, **kw)
    arrays = whole._device_arrays()
    assert whole._pair_chunk_for(arrays) is None and whole._unary_chunk_for(arrays) is None
    monkeypatch.setattr(tgprf, "_auto_chunk", functools.partial(tgprf._auto_chunk,
                                                                 budget_bytes=4096))
    chunked = tgprf.GPRF(X, Y, None, cov, 0.01, **kw)
    assert len(g.neighbors) > 8 and chunked._pair_chunk_for(arrays) == 8
    assert chunked._unary_chunk_for(arrays) == 8
    for c, u in zip(chunked.llgrad(grad_X=True, grad_cov=True),
                    whole.llgrad(grad_X=True, grad_cov=True)):
        _close(c, u, CHUNK_RTOL)


@pytest.mark.parametrize("shape", [(342, 1776), (180, 1776), (100, 888), (342, 272), (9, 48),
                                   (4000, 40)])
def test_auto_chunk_matches_jax(shape):
    assert tgprf._auto_chunk(*shape) == jgprf._auto_chunk(*shape)


def test_fused_seismic_pair_chunk_equals_unchunked():
    """The seismic engine's explicit pair_chunk, on a small catalog."""
    from gprf_torch.data import seismic as tseis
    from gprf_torch.partition import pdtree as tpdtree

    cat = tseis.make_synthetic_catalog(n=150, seed=3)
    X = cat[:, (tseis.COL_LON, tseis.COL_LAT, tseis.COL_DEPTH)]
    X2 = X[:, :2].copy()
    X2[:, 0] = tpdtree.wrap_lon(X2[:, 0])
    tree = tpdtree.PDTree(X2, 20)
    cov = cov_from_numpy([1.0], [40.0, 40.0], "lld", "matern32", **F64)
    Y = np.random.default_rng(4).standard_normal((len(X), 3))
    g = tgprf.GPRF(X, Y, None, cov, 0.1, block_idxs=tree.leaf_idx(), neighbor_threshold=0.01,
                   **F64)
    assert len(g.neighbors) > 3
    prior_std = np.array([0.2, 0.2, 20.0])
    out = []
    for chunk in (None, 3):
        fused = FusedSeismicGPRF(X, Y, tree, g.neighbors, X, prior_std, cov, 0.1, task="xcov",
                                 pair_chunk=chunk, acc_dtype=torch.float64, **F64)
        theta = torch.as_tensor(fused.theta0(X, [[0.1, 1.0, 40.0, 40.0]])).requires_grad_(True)
        v = fused.loss_fn()(theta)
        out.append((v.detach(), torch.autograd.grad(v, theta)[0]))
    for c, u in zip(*out):
        _close(u, c, CHUNK_RTOL)
