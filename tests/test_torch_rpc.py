"""gprf_torch's RPC partitions against gprf_tpu's on the same seeds, float64
on the CPU: the host split and its replay, the flattened tree, the median
replay on the device (float64 equal, float32 counted, replicas folded), the
fused engine over an RPC partition for tasks x, cov and xcov, a short
device-loop trajectory, and the dataset's RPC partition."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gprf_tpu.data import sampled as jsampled
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.model import fused as jfused
from gprf_tpu.optim import device_lbfgs as jlbfgs
from gprf_tpu.partition import rpc as jrpc
from gprf_tpu.partition import rpc_device as jrpc_device
from gprf_torch.data import sampled as tsampled
from gprf_torch.model import fused as tfused
from gprf_torch.model.gprf import GPRF
from gprf_torch.optim import lbfgs as tlbfgs
from gprf_torch.partition import rpc as trpc
from gprf_torch.partition import rpc_device as trpc_device
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-6
LOG_ATOL = 0.011  # log.txt keeps two decimals of the objective


def _labels(blocks, n):
    lab = np.empty(n, dtype=np.int64)
    for b, ix in enumerate(blocks):
        lab[ix] = b
    return lab


def _assert_same_tree(t, j):
    if j == ():
        assert t == ()
        return
    ((tn, tx), t1, t2), ((jn, jx), j1, j2) = t, j
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tx, jx)
    _assert_same_tree(t1, j1)
    _assert_same_tree(t2, j2)


def _both_splits(seed, n, target):
    """(X, torch blocks, torch tree, jax blocks, jax tree) of one seed: the
    reference draws from NumPy's global stream, the port from a RandomState."""
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    np.random.seed(seed)
    jb, jt = jrpc.cluster_rpc(X, np.arange(n), target_size=target)
    tb, tt = trpc.cluster_rpc(X, np.arange(n), target_size=target,
                              rng=np.random.RandomState(seed))
    return X, tb, tt, jb, jt


def _replay(X, tree, dtype=torch.float64):
    flat = trpc_device.FlatRPCTree(tree, d=X.shape[-1])
    return trpc_device.assign_blocks_rpc(torch.as_tensor(X, dtype=dtype),
                                         flat.device_arrays(device="cpu", dtype=dtype),
                                         flat.depth, flat.n_nodes).numpy()


@pytest.mark.parametrize("seed,n,target", [(0, 500, 60), (3, 333, 40), (7, 1000, 200)])
def test_cluster_rpc_matches_jax_and_replays_alike(seed, n, target):
    X, tb, tt, jb, jt = _both_splits(seed, n, target)
    assert len(tb) == len(jb) and max(len(b) for b in tb) < target
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    _assert_same_tree(tt, jt)
    Xp = X + np.random.default_rng(seed + 1).standard_normal(X.shape) * 0.03
    for a, b in zip(trpc.cluster_rpc(Xp, np.arange(n), target, fixed_split=tt)[0],
                    jrpc.cluster_rpc(Xp, np.arange(n), target, fixed_split=jt)[0]):
        np.testing.assert_array_equal(a, b)


def test_a_fresh_split_needs_an_rng():
    with pytest.raises(ValueError, match="rng"):
        trpc.cluster_rpc(np.zeros((10, 2)), np.arange(10), 4)
    assert trpc.cluster_rpc(np.zeros((3, 2)), np.arange(3), 4)[1] == ()  # a leaf draws nothing


def test_flat_tree_matches_jax_from_the_references_tree():
    X, _, _, jb, jt = _both_splits(1, 400, 50)
    t, j = trpc_device.FlatRPCTree(jt, d=2), jrpc_device.FlatRPCTree(jt, d=2)
    assert (t.depth, t.n_nodes, t.n_blocks) == (j.depth, j.n_nodes, j.n_blocks) and \
        t.n_blocks == len(jb)
    for k in ("direction", "origin", "left", "right", "leaf_block"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    arrays = t.device_arrays(**F64)
    assert arrays["direction"].dtype == torch.float64 and arrays["left"].dtype == torch.int64


@pytest.mark.parametrize("seed,n,target", [(0, 500, 60), (5, 700, 90)])
def test_assign_blocks_rpc_matches_jax_and_the_host_replay(seed, n, target):
    X, tb, tt, _, jt = _both_splits(seed, n, target)
    jflat = jrpc_device.FlatRPCTree(jt, d=2)
    Xp = X + np.random.default_rng(seed + 2).standard_normal(X.shape) * 0.03
    for XX in (X, Xp):
        host = _labels(trpc.cluster_rpc(XX, np.arange(n), target, fixed_split=tt)[0], n)
        j = np.asarray(jrpc_device.assign_blocks_rpc(jnp.asarray(XX),
                                                     jflat.device_arrays(jnp.float64),
                                                     jflat.depth, jflat.n_nodes))
        t = _replay(XX, tt)
        np.testing.assert_array_equal(t, host)
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(_replay(X, tt), _labels(tb, n))


def test_assign_blocks_rpc_in_float32_moves_few_points():
    """Float32 projections near a node's median may fall on the other side
    of it than the float64 host's: 1,000 points moved by N(0, 0.03^2),
    counted, at most 2 in another block."""
    X, _, tt, _, _ = _both_splits(11, 1000, 80)
    Xp = X + np.random.default_rng(12).standard_normal(X.shape) * 0.03
    host = _labels(trpc.cluster_rpc(Xp, np.arange(1000), 80, fixed_split=tt)[0], 1000)
    moved = int(np.sum(_replay(Xp, tt, torch.float32) != host))
    assert moved <= 2, moved


def test_assign_blocks_rpc_folds_replicas():
    """[R, n, d] replays each replica on its own points: one replica squashed
    into a corner (empty nodes), one moved, one as drawn."""
    X, _, tt, _, _ = _both_splits(4, 400, 50)
    rng = np.random.default_rng(4)
    Xs = np.stack([X, X * 0.01, X + rng.standard_normal(X.shape) * 0.05])
    folded = _replay(Xs, tt)
    assert folded.shape == (3, 400)
    for r in range(3):
        np.testing.assert_array_equal(folded[r], _replay(Xs[r], tt))
        host = _labels(trpc.cluster_rpc(Xs[r], np.arange(400), 50, fixed_split=tt)[0], 400)
        np.testing.assert_array_equal(folded[r], host)


def _logged(d):
    """log.txt's objective column (its rows start with the step index)."""
    with open(os.path.join(d, "log.txt")) as f:
        return np.array([float(line.split()[2]) for line in f if line[0].isdigit()])


def _rpc_problem(seed, n=200, dy=4, target=40):
    """A problem over an RPC partition: the edges from the host GPRF at
    threshold 0.1, as the command line builds them."""
    rng = np.random.default_rng(seed)
    SX = rng.uniform(size=(n, 2))
    X_obs = SX + rng.standard_normal((n, 2)) * 0.02
    Y = rng.standard_normal((n, dy))
    blocks, tree = trpc.cluster_rpc(X_obs, np.arange(n), target, rng=np.random.RandomState(seed))
    g = GPRF(X_obs, Y, lambda X: trpc.cluster_rpc(X, np.arange(n), target, fixed_split=tree)[0],
             cov_from_numpy([1.0], [0.3, 0.3], **F64), 0.01, block_idxs=blocks,
             neighbor_threshold=0.1, **F64)
    assert len(g.neighbors) > 0
    return dict(X_obs=X_obs, Y=Y, tree=tree, edges=g.neighbors)


def _rpc_pair(p, task="x", C0=None, **kw):
    args = (p["X_obs"], p["Y"], p["edges"], p["X_obs"], 0.02)
    C0 = None if C0 is None else np.asarray(C0)
    jf = jfused.FusedSyntheticGPRF(*args, JCov.create([1.0], [0.3, 0.3]), 0.01, task=task,
                                   C0=C0, rpc_tree=p["tree"], **kw)
    tf = tfused.FusedSyntheticGPRF(*args, cov_from_numpy([1.0], [0.3, 0.3], **F64), 0.01,
                                   task=task, C0=C0, rpc_tree=p["tree"], **kw, **F64)
    return jf, tf


@pytest.mark.parametrize("task,C0", [("x", None), ("cov", [[0.02, 1.2, 0.25, 0.35]]),
                                     ("xcov", [[0.25]])])
def test_fused_rpc_loss_and_gradient_match_jax(task, C0):
    jf, tf = _rpc_pair(_rpc_problem(1), task, C0)
    assert tf.kind == "rpc" and tf.m == jf.m and tf.n_blocks == jf.n_blocks
    theta = tf.theta0()
    np.testing.assert_array_equal(theta, jf.theta0())
    theta = theta + np.random.default_rng(2).normal(size=theta.shape) * 0.01  # re-blocks
    v_ref, g_ref = jax.value_and_grad(jf.loss_fn())(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    v = tf.loss_fn()(th)
    (g,) = torch.autograd.grad(v, th)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-9)
    assert np.abs(g.numpy() - np.asarray(g_ref)).max() <= 1e-7 * np.abs(np.asarray(g_ref)).max()


def test_fused_rpc_capacity_checks_match_jax():
    p = _rpc_problem(2)
    jf, tf = _rpc_pair(p)
    rng = np.random.default_rng(3)
    x0 = p["X_obs"].reshape(-1)
    # squashed toward one corner the medians follow the points: the blocks
    # stay balanced; a few points pulled across a line overflow one block
    thetas = np.stack([x0, x0 * 0.01, x0 + rng.normal(size=x0.shape) * 0.2])
    for th in thetas:
        assert tf.check_capacity(th) == jf.check_capacity(th)
        assert bool(tf.overflow_fn()(torch.as_tensor(th))) == bool(
            jf.overflow_fn()(jnp.asarray(th)))
    assert tf.check_capacity_batch(thetas) == jf.check_capacity_batch(thetas)
    np.testing.assert_array_equal(tf.overflow_fn()(torch.as_tensor(thetas)).numpy(),
                                  np.asarray(jax.vmap(jf.overflow_fn())(jnp.asarray(thetas))))


def test_fused_rpc_folded_loss_matches_single_replicas():
    jf, tf = _rpc_pair(_rpc_problem(3))
    rng = np.random.default_rng(4)
    x0 = tf.theta0()
    thetas = torch.as_tensor(np.stack([x0, x0 + rng.normal(size=x0.shape) * 0.01]))
    folded = tf.loss_fn()(thetas)
    single = torch.stack([tf.loss_fn()(t) for t in thetas])
    np.testing.assert_allclose(folded.numpy(), single.numpy(), rtol=1e-12)
    labels = tf._assign_device(thetas.reshape(2, -1, 2))
    for r in range(2):
        np.testing.assert_array_equal(labels[r].numpy(), tf._assign_host(thetas[r].reshape(-1, 2)))


def test_do_optimization_fused_over_rpc_matches_jax(tmp_path):
    p = _rpc_problem(5, n=240)
    jf, tf = _rpc_pair(p)
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    os.makedirs(dt)
    os.makedirs(dj)
    kw = dict(max_iters=10, steps_per_dispatch=5, ckpt_every_sec=0.0)
    tx = tlbfgs.do_optimization_fused(dt, tf, p["X_obs"], **kw)
    jx = jlbfgs.do_optimization_fused(dj, jf, p["X_obs"], **kw)
    tv, jv = _logged(dt), _logged(dj)
    assert len(tv) == len(jv) == 10 and tv[-1] > tv[0] and tf.m == jf.m
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=LOG_ATOL)
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=RTOL, atol=1e-9)


def test_sample_data_with_an_rpc_partition_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    monkeypatch.delenv("GPRF_SAMPLER", raising=False)
    args = (330, 300, 0.15, 0.02, 4, 2, None, 0.01)
    t = tsampled.sample_data(*args, rpc_blocksize=50)
    j = jsampled.sample_data(*args, rpc_blocksize=50)
    assert t.neighbors is None and j.neighbors is None
    assert len(t.block_idxs) == len(j.block_idxs) == 8
    for a, b in zip(t.block_idxs, j.block_idxs):
        np.testing.assert_array_equal(a, b)
    _assert_same_tree(t.rpc_splits, j.rpc_splits)
    for a, b in zip(t.reblock(t.SX), j.reblock(j.SX)):
        np.testing.assert_array_equal(a, b)
    # the cached dataset is arrays only, and the partition is drawn anew
    assert sorted(os.listdir(tmp_path / "synthetic_datasets")) == [
        "330_300_0.150000_0.020000_4_2.npz", "330_300_0.150000_0.020000_4_2.pkl"]
    again = tsampled.sample_data(*args, rpc_blocksize=50)
    for a, b in zip(again.block_idxs, t.block_idxs):
        np.testing.assert_array_equal(a, b)
    # build_gprf discovers the edges at local_dist on both sides
    tg = t.build_gprf(local_dist=0.1, **F64)
    jg = j.build_gprf(local_dist=0.1)
    assert tg.neighbors == [tuple(map(int, e)) for e in jg.neighbors] and tg.neighbors
    np.testing.assert_allclose(tg.llgrad()[0], float(jg.llgrad()[0]), rtol=1e-9)


def test_sampled_data_cluster_rpc_matches_jax():
    kw = dict(n=330, ntrain=300, lscale=0.15, obs_std=0.02, yd=4, seed=2, noise_var=0.01)
    t, j = tsampled.SampledData(**kw), jsampled.SampledData(**kw)
    t.cluster_rpc(70, rng=np.random.RandomState(9))
    np.random.seed(9)
    j.cluster_rpc(70)
    for a, b in zip(t.block_idxs, j.block_idxs):
        np.testing.assert_array_equal(a, b)
    X = t.X_obs + np.random.default_rng(0).normal(size=t.X_obs.shape) * 0.02
    for a, b in zip(t.reblock(X), j.reblock(X)):
        np.testing.assert_array_equal(a, b)
