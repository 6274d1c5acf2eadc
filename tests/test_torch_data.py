"""gprf_torch's data path against gprf_tpu's on the same seeds: the host
kernel matrices, jitchol, the synthetic samplers, SampledData, its cache,
BlockLayout and the priors.  Float64 on the CPU (the conftest turns the
reference's 64-bit mode on, which its sampler's kernel matrix follows)."""

import builtins
import os

import numpy as np
import pytest
import torch

from gprf_tpu.data import sampled as jsampled
from gprf_tpu.data import synthetic as jsynth
from gprf_tpu.kernels import hostnp as jhostnp
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.linalg.jitchol import jitchol as j_jitchol
from gprf_tpu.optim import priors as jpriors
from gprf_tpu.partition.grid import grid_centers
from gprf_tpu.partition.layout import BlockLayout as JLayout
from gprf_tpu.utils import io as jio
from gprf_torch.data import sampled as tsampled
from gprf_torch.data import synthetic as tsynth
from gprf_torch.kernels import hostnp as thostnp
from gprf_torch.kernels.covfn import kernel_matrix
from gprf_torch.linalg.jitchol import jitchol as t_jitchol
from gprf_torch.optim import priors as tpriors
from gprf_torch.partition.layout import BlockLayout as TLayout
from gprf_torch.utils import convert
from gprf_torch.utils import io as tio
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)

# one seed of each family of latent shapes: uniform, fault (wide and
# n-scaled spread), X, diamond, crazy lines, tight crazy lines
# (the crazy lines need n >= ~1200: their segments, of length ~41 / sqrt(n),
# must fit the unit square)
SHAPE_SEEDS = [(3, 500), (1003, 500), (1007, 500), (1100, 500), (1200, 500), (1300, 1500),
               (1350, 1500)]


@pytest.mark.parametrize("wfn_str", ["se", "matern32"])
def test_host_kernel_matrices_match_jax_and_the_tensor_kernels(wfn_str):
    rng = np.random.default_rng(0)
    X1, X2 = rng.uniform(size=(40, 2)), rng.uniform(size=(30, 2))
    jcov = JCov.create([1.3], [0.2, 0.4], "euclidean", wfn_str)
    tcov = cov_from_numpy([1.3], [0.2, 0.4], "euclidean", wfn_str, **F64)
    np.testing.assert_allclose(thostnp.cross_kernel_matrix_np(tcov, X1, X2),
                               jhostnp.cross_kernel_matrix_np(jcov, X1, X2), rtol=1e-14)
    K = thostnp.kernel_matrix_np(tcov, X1, noise_var=0.05)
    np.testing.assert_allclose(K, jhostnp.kernel_matrix_np(jcov, X1, noise_var=0.05), rtol=1e-14)
    np.testing.assert_allclose(K, kernel_matrix(tcov, torch.as_tensor(X1), 0.05).numpy(),
                               rtol=1e-12)


def test_host_kernel_refuses_the_seismic_distance():
    """The host great-circle distance, once refused, matches gprf_tpu's."""
    cov = cov_from_numpy([1.0], [10.0, 5.0], "lld", "se", **F64)
    jcov = JCov.create([1.0], [10.0, 5.0], "lld", "se")
    X = np.array([[140.0, 10.0, 5.0], [140.1, 10.05, 9.0], [141.0, 9.0, 30.0]])
    np.testing.assert_allclose(thostnp.cross_kernel_matrix_np(cov, X, X[::-1]),
                               jhostnp.cross_kernel_matrix_np(jcov, X, X[::-1]), rtol=1e-13)


def test_jitchol_matches_jax_with_and_without_jitter():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(12, 12))
    pd = A @ A.T + np.eye(12)
    np.testing.assert_array_equal(t_jitchol(pd), j_jitchol(pd))
    v = rng.normal(size=(12, 3))
    singular = v @ v.T + np.diag(np.r_[np.zeros(6), np.ones(6)]) * 1e-30  # rank 3: needs jitter
    singular[np.diag_indices(12)] = np.maximum(np.diag(singular), 1e-3)
    np.testing.assert_array_equal(t_jitchol(singular), j_jitchol(singular))
    with pytest.raises(np.linalg.LinAlgError):
        t_jitchol(-np.eye(3))


@pytest.mark.parametrize("seed,n", SHAPE_SEEDS)
def test_sample_synthetic_matches_jax(seed, n):
    """X is bit-equal (the same NumPy stream); Y agrees to rtol 1e-8 (two
    float64 Choleskys of kernel matrices that differ in the last bits)."""
    kw = dict(seed=seed, n=n, yd=3, lscale=0.1, noise_var=0.01)
    tX, tY, tcov = tsynth.sample_synthetic(**kw)
    jX, jY, jcov = jsynth.sample_synthetic(**kw)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_allclose(tY, jY, rtol=1e-8, atol=1e-9)
    np.testing.assert_array_equal(tcov.dfn_params.numpy(), np.asarray(jcov.dfn_params))
    assert tY.dtype == np.float64 and tcov.dfn_params.dtype == torch.float64


@pytest.mark.parametrize("seed", [1003, 1300])
def test_sample_crazy_shape_matches_jax(seed):
    np.testing.assert_array_equal(tsynth.sample_crazy_shape(seed, 1700),
                                  jsynth.sample_crazy_shape(seed, 1700))


def test_crazy_shape_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        tsynth.sample_crazy_shape(1400, 100)


def test_samplers_past_the_dense_limit_are_not_ported_yet(monkeypatch):
    """Past the dense limit every GPRF_SAMPLER is served and draws the
    reference's Y from the same seed: with the limit moved down to 200
    points, "" takes the sparse draw and "vecchia" and "hi" the Vecchia
    draw at n = 300 (the dispatch at the real sizes is
    tests/test_torch_large_draw.py's)."""
    assert tsynth.DENSE_SAMPLING_LIMIT == jsynth.DENSE_SAMPLING_LIMIT
    for mod in (tsynth, jsynth):
        monkeypatch.setattr(mod, "DENSE_SAMPLING_LIMIT", 200)
    X = np.random.RandomState(1).rand(300, 2)
    for sampler in ("", "vecchia", "hi"):
        monkeypatch.setenv("GPRF_SAMPLER", sampler)
        np.random.seed(5)
        ref = jsynth.sample_y(X, JCov.create([1.0], [0.1, 0.1]), 0.01, 3)
        got = tsynth.sample_y(X, cov_from_numpy([1.0], [0.1, 0.1], **F64), 0.01, 3,
                              rng=np.random.RandomState(5))
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("sampler", ["", "vecchia", "hi"])
@pytest.mark.parametrize("n", [10500, 80000])
def test_sampler_suffix_matches_jax(monkeypatch, sampler, n):
    monkeypatch.setenv("GPRF_SAMPLER", sampler)
    assert tsynth.sampler_suffix(n) == jsynth.sampler_suffix(n)


def _both_sampled(**kw):
    kw = dict(dict(n=330, ntrain=300, lscale=0.15, obs_std=0.02, yd=4, seed=2, noise_var=0.01),
              **kw)
    return tsampled.SampledData(**kw), jsampled.SampledData(**kw)


def _assert_same_data(t, j):
    np.testing.assert_array_equal(t.SX, j.SX)
    np.testing.assert_array_equal(t.X_obs, j.X_obs)
    np.testing.assert_array_equal(t.Xtest, j.Xtest)
    np.testing.assert_allclose(t.SY, j.SY, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(t.Ytest, j.Ytest, rtol=1e-8, atol=1e-9)
    for k in ("noise_var", "n", "ntrain", "lscale", "obs_std"):
        assert getattr(t, k) == getattr(j, k)


@pytest.mark.parametrize("seed", [2, 1201])
def test_sampled_data_matches_jax(seed):
    t, j = _both_sampled(seed=seed)
    _assert_same_data(t, j)
    centers = grid_centers(9)
    t.set_centers(centers)
    j.set_centers(centers)
    assert t.neighbors == j.neighbors
    for a, b in zip(t.block_idxs, j.block_idxs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.reblock(t.SX), j.reblock(j.SX)):
        np.testing.assert_array_equal(a, b)


def test_sampled_data_metrics_and_priors_match_jax():
    t, j = _both_sampled()
    centers = grid_centers(4)
    t.set_centers(centers)
    j.set_centers(centers)
    x = (t.X_obs + np.random.default_rng(0).normal(size=t.X_obs.shape) * 0.01).flatten()
    for name in ("mean_distance", "mean_abs_err", "median_abs_err"):
        assert getattr(t, name)(x) == getattr(j, name)(x)
    FC = np.array([[0.01, 1.0, 0.2, 0.2]])
    assert t.lscale_error(FC) == j.lscale_error(FC)
    for a, b in zip(t.x_prior(x), j.x_prior(x)):
        np.testing.assert_allclose(a, b, rtol=1e-14)
    xb = t.SX[t.block_idxs[2]].flatten()
    for a, b in zip(t.x_prior_block(2, xb), j.x_prior_block(2, xb)):
        np.testing.assert_allclose(a, b, rtol=1e-14)
    np.random.seed(5)  # the reference draws from NumPy's global stream
    np.testing.assert_array_equal(t.random_init(np.random.RandomState(5)), j.random_init())


def test_sampled_data_from_the_references_arrays():
    t, j = _both_sampled()
    cov_row = [j.noise_var, *np.asarray(j.cov.wfn_params), *np.asarray(j.cov.dfn_params)]
    c = convert.sampled_data_from_numpy(j.SX, j.SY, j.Xtest, j.Ytest, j.X_obs, cov_row,
                                        j.lscale, j.obs_std)
    _assert_same_data(c, j)
    np.testing.assert_array_equal(c.cov_row(), t.cov_row())
    np.testing.assert_array_equal(c.SY, j.SY)


def test_rpc_partition_of_the_dataset_matches_jax():
    t, j = _both_sampled()
    t.cluster_rpc(50, rng=np.random.RandomState(2))
    np.random.seed(2)  # the reference draws its split points from NumPy's global stream
    j.cluster_rpc(50)
    assert t.neighbors is None and j.neighbors is None and len(t.block_idxs) == 8
    for a, b in zip(t.block_idxs, j.block_idxs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.reblock(t.SX), j.reblock(j.SX)):
        np.testing.assert_array_equal(a, b)


def test_predictive_scores_match_jax():
    """prediction_error on a grid partition and prediction_error_gp, on one
    dataset (the reference's SY, which differs from the port's draw in the
    last bits)."""
    t, j = _both_sampled()
    t.SY, t.Ytest = j.SY.copy(), j.Ytest.copy()
    for s in (t, j):
        s.set_centers(grid_centers(4))
    np.testing.assert_allclose(t.prediction_error(local_dist=0.1, **F64),
                               j.prediction_error(local_dist=0.1), rtol=1e-6)
    np.testing.assert_allclose(t.prediction_error_gp(t.X_obs, **F64),
                               j.prediction_error_gp(j.X_obs), rtol=1e-9)


def test_dataset_cache_holds_arrays_and_never_opens_a_pickle(tmp_path, monkeypatch):
    monkeypatch.setenv("GPRF_EXPERIMENTS", str(tmp_path))
    assert tsampled.exp_base_dir() == jsampled.exp_base_dir() == str(tmp_path)
    args = dict(n=230, ntrain=200, lscale=0.15, obs_std=0.02, yd=3, seed=4,
                centers=grid_centers(4), noise_var=0.02)
    # a file under the reference's key that no unpickler would survive
    key = "230_200_0.150000_0.020000_3_4_0.0200"
    cache = tmp_path / "synthetic_datasets"
    cache.mkdir()
    (cache / (key + ".pkl")).write_bytes(b"not a pickle")
    opened = []
    real_open = builtins.open

    def recording_open(file, *a, **k):
        opened.append(str(file))
        return real_open(file, *a, **k)

    monkeypatch.setattr(builtins, "open", recording_open)
    first = tsampled.sample_data(**args)
    assert sorted(os.listdir(cache)) == [key + ".npz", key + ".pkl"]
    monkeypatch.setattr(tsampled, "sample_synthetic", None)  # the second call must not sample
    second = tsampled.sample_data(**args)
    monkeypatch.undo()
    assert opened and not [p for p in opened if p.endswith(".pkl")]
    _assert_same_data(second, first)
    np.testing.assert_array_equal(second.SY, first.SY)
    np.testing.assert_array_equal(second.cov_row(), first.cov_row())
    assert second.neighbors == first.neighbors and second.noise_var == 0.02
    with np.load(cache / (key + ".npz"), allow_pickle=False) as z:
        assert set(z.files) == {"SX", "SY", "Xtest", "Ytest", "X_obs", "cov_row", "lscale",
                                "obs_std"}


def _random_partition(seed, n, B):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, B, size=n)
    blocks = [np.flatnonzero(labels == b) for b in range(B)]
    edges = [(i, j) for i in range(B) for j in range(i) if rng.uniform() < 0.4]
    return blocks, edges


@pytest.mark.parametrize("seed,n,B,pad_to", [(0, 200, 6, None), (1, 90, 4, 48), (2, 50, 3, None)])
def test_block_layout_matches_jax(seed, n, B, pad_to):
    blocks, edges = _random_partition(seed, n, B)
    t = TLayout.from_blocks(blocks, n, edges, pad_to=pad_to)
    j = JLayout.from_blocks(blocks, n, edges, pad_to=pad_to)
    for f in ("assignment", "mask", "sizes", "edges", "neighbor_count", "pair_assignment",
              "pair_mask"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (t.n, t.n_blocks, t.block_pad, t.n_edges) == (j.n, j.n_blocks, j.block_pad, j.n_edges)
    np.testing.assert_array_equal(t.unary_weights(), j.unary_weights())
    for a, b in zip(t.block_idxs(), j.block_idxs()):
        np.testing.assert_array_equal(a, b)
    for pad_edges_to in (None, len(edges) + 3):
        ta = t.device_arrays(pad_edges_to=pad_edges_to, **F64)
        ja = j.device_arrays(pad_edges_to=pad_edges_to)
        assert set(ta) == set(ja)
        for k in ta:
            np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))
        assert ta["edges"].dtype == ta["assignment"].dtype == torch.int64
        assert ta["mask"].dtype == torch.bool and ta["unary_weights"].dtype == torch.float64
    back = convert.layout_from_numpy(j.assignment, j.mask, j.sizes, j.edges)
    np.testing.assert_array_equal(back.pair_assignment, j.pair_assignment)
    np.testing.assert_array_equal(back.neighbor_count, j.neighbor_count)


def test_block_layout_edge_cases_match_jax():
    blocks, _ = _random_partition(3, 40, 3)
    t, j = TLayout.from_blocks(blocks, 40), JLayout.from_blocks(blocks, 40)
    assert t.pair_assignment.shape == j.pair_assignment.shape == (0, 2 * t.block_pad)
    assert t.device_arrays(**F64)["edges"].shape == (0, 2)
    with pytest.raises(ValueError):
        TLayout.from_blocks(blocks, 40, pad_to=2)


@pytest.mark.parametrize("name,c", [("synthetic_cov_prior", [-1.2, 0.3, -2.0, -2.5]),
                                    ("seismic_cov_prior", [-2.0, 0.1, 3.0, 4.0]),
                                    ("seismic_cov_prior", [-2.0, 0.1, 5.05, 4.0])])
def test_cov_priors_match_jax(name, c):
    for a, b in zip(getattr(tpriors, name)(c), getattr(jpriors, name)(c)):
        np.testing.assert_array_equal(a, b)


def test_gaussian_x_prior_matches_jax():
    rng = np.random.default_rng(0)
    X, means = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for a, b in zip(tpriors.gaussian_x_prior(X, means, (0.01, 0.01, 1.0)),
                    jpriors.gaussian_x_prior(X, means, (0.01, 0.01, 1.0))):
        np.testing.assert_array_equal(a, b)


def test_step_files_have_the_references_names(tmp_path):
    assert tio.step_x_path("d", 7) == jio.step_x_path("d", 7)
    assert tio.step_cov_path("d", 12345) == jio.step_cov_path("d", 12345)
    tio.mkdir_p(str(tmp_path / "a" / "b"))
    tio.save_step(str(tmp_path / "a" / "b"), 3, X=np.ones((2, 2)), FC=np.ones((1, 4)))
    assert sorted(os.listdir(tmp_path / "a" / "b")) == ["step_00003_X.npy", "step_00003_cov.npy"]
