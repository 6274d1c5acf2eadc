import numpy as np
import torch

from gprfbench import data as bdata

CFG = {"ntrain": 300, "dx": 2, "yd": 4, "nblocks": 9, "lscale": 0.2, "signal_var": 1.0,
       "noise_var": 0.01, "obs_std": 0.02, "local_dist": 0.1,
       "assumed": {"y_draw": "exact", "rff_features": 4096}}


def problem(seed, **over):
    cfg = dict(CFG, **over)
    return bdata.Problem(cfg, cfg["local_dist"], seed, torch.device("cpu"))


def test_same_seed_same_data_other_seed_other_data():
    a, b, c = problem(2**31 + 9), problem(2**31 + 9), problem(2**31 + 10)
    np.testing.assert_array_equal(a.SX, b.SX)
    np.testing.assert_array_equal(a.Y, b.Y)
    np.testing.assert_array_equal(a.x_obs(bdata.JOB, 3), b.x_obs(bdata.JOB, 3))
    assert not np.array_equal(a.SX, c.SX)
    assert not np.array_equal(a.x_obs(bdata.JOB, 0), a.x_obs(bdata.JOB, 1))


def test_large_seeds_are_distinct_streams():
    seeds = {bdata.stream_seed(s, bdata.JOB, j) for s in (0, 2**31, 2**33 + 1) for j in range(3)}
    assert len(seeds) == 9 and all(0 <= s < 2**63 for s in seeds)


def test_grid_and_edges_of_the_command_line():
    c = bdata.grid_centers(100)
    assert c.shape == (100, 2) and np.isclose(c[0], [0.05, 0.05]).all()
    assert np.isclose(c[1], [0.05, 0.15]).all()  # x-major, as gprfopt.py's list
    e = bdata.grid_edges(c)
    assert len(e) == 342 and (e[:, 0] > e[:, 1]).all()
    assert len(bdata.grid_edges(bdata.grid_centers(4))) == 6
    assert problem(1, local_dist=1.0).edges.shape == (0, 2)


def test_draws_have_the_prior_covariance():
    """Both draws give Y with the kernel's covariance: the empirical
    covariance of two points' columns against k + noise on the diagonal."""
    for kind in ("exact", "rff"):
        p = problem(3, ntrain=4, yd=20000, assumed={"y_draw": kind, "rff_features": 20000})
        emp = p.Y @ p.Y.T / p.Y.shape[1]
        X = torch.as_tensor(p.SX)
        K = (bdata.se_kernel(X, X, 0.2, 1.0) + 0.01 * torch.eye(4)).numpy()
        np.testing.assert_allclose(emp, K, atol=0.05)


def test_mad_is_mean_absolute_error():
    p = problem(4)
    assert p.mad(p.SX) == 0.0
    assert np.isclose(p.mad(p.SX + 0.5), 0.5)
