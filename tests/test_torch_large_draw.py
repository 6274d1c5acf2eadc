"""The prior draws past the dense limit in gprf_torch against gprf_tpu's on
the same seeds, float64 on the host: the Vecchia draw sample_y_blocked, the
exact banded draw sample_y_banded (and its exact transform M M^T = K), and
sample_y's choice among the samplers at the sizes where it changes."""

import numpy as np
import pytest
import torch

import gprf_tpu.sparse as jsparse_pkg
from gprf_tpu.data import synthetic as jsynth
from gprf_tpu.kernels.gpcov import GPCov as JCov
from gprf_tpu.sparse import ops as jsparse
from gprf_torch.data import synthetic as tsynth
from gprf_torch.sparse import ops as tsparse
from gprf_torch.utils.convert import cov_from_numpy

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _covs(ls=(0.08, 0.08)):
    return cov_from_numpy([1.0], list(ls), **F64), JCov.create([1.0], list(ls))


def test_sample_y_blocked_matches_jax():
    """n = 600 in blocks of 64, conditioned on at most 100 points, 8 nearest
    each: nine conditional draws, the conditioning set capped in most."""
    X = np.random.RandomState(2).rand(600, 2)
    tcov, jcov = _covs()
    kw = dict(blocksize=64, n_condition=100, knn=8)
    got = tsynth.sample_y_blocked(X, tcov, 0.01, 3, rng=np.random.RandomState(7), **kw)
    ref = jsynth.sample_y_blocked(X, jcov, 0.01, 3, rng=np.random.RandomState(7), **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_sample_y_banded_matches_jax():
    X = np.random.RandomState(3).rand(500, 2)
    tcov, jcov = _covs()
    got = tsparse.sample_y_banded(X, tcov, 0.01, 3, rng=np.random.RandomState(8))
    ref = jsparse.sample_y_banded(X, jcov, 0.01, 3, rng=np.random.RandomState(8))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_sample_y_banded_exact_transform():
    """The banded draw's map z -> y is a factor of the truncated kernel:
    M M^T = K (tests/test_sparse.py's check of the reference)."""
    X = np.random.RandomState(4).uniform(size=(120, 2))
    tcov, _ = _covs((0.2, 0.2))

    class IdentityRng:
        def standard_normal(self, shape):
            return np.eye(shape[0])

    M = tsparse.sample_y_banded(X, tcov, 0.05, 120, rng=IdentityRng())
    K = tsparse.sparse_kernel_matrix(X, tcov, max_scaled_dist=4.0, noise_var=0.05).toarray()
    np.testing.assert_allclose(M @ M.T, K, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n", [12000, 20001])
@pytest.mark.parametrize("sampler", ["", "vecchia", "hi"])
def test_sample_y_dispatch_matches_jax(monkeypatch, sampler, n):
    """Each package's samplers replaced by recorders, so nothing large is
    drawn: the same sampler with the same options in both."""
    calls = {"torch": [], "jax": []}

    def recorder(pkg, name):
        def f(X, cov, noise_var, yd, **kw):
            kw = {k: v for k, v in kw.items() if k not in ("rng", "verbose")}
            calls[pkg].append((name, len(X), yd, kw))
            return np.zeros((len(X), yd))
        return f

    for pkg, sparse_mod, synth in (("torch", tsparse, tsynth), ("jax", jsparse_pkg, jsynth)):
        monkeypatch.setattr(sparse_mod, "sample_y_sparse", recorder(pkg, "sparse"))
        monkeypatch.setattr(sparse_mod, "sample_y_banded", recorder(pkg, "banded"))
        monkeypatch.setattr(synth, "sample_y_blocked", recorder(pkg, "blocked"))
    monkeypatch.setenv("GPRF_SAMPLER", sampler)
    tcov, jcov = _covs()
    X = np.zeros((n, 2))
    tsynth.sample_y(X, tcov, 0.01, 2, rng=np.random.RandomState(0))
    jsynth.sample_y(X, jcov, 0.01, 2)
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 1
