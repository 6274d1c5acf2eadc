import math

import numpy as np
import torch

from gprfbench import data as bdata
from gprfbench import reference as ref


def dense_ll(X, Y, terms, lscale, nv):
    """The joint form term by term in NumPy float64: slogdet and solve."""
    total = 0.0
    for w, idx in terms:
        Xt, Yt = X[idx], Y[idx]
        d2 = ((Xt[:, None, :] - Xt[None, :, :]) ** 2).sum(-1)
        K = np.exp(-d2 / lscale**2) + nv * np.eye(len(idx))
        _, logdet = np.linalg.slogdet(K)
        quad = np.sum(Yt * np.linalg.solve(K, Yt))
        total += w * (-0.5 * quad - 0.5 * Yt.shape[1] * logdet
                      - 0.5 * Yt.size * math.log(2 * math.pi))
    return total


def setup(seed=0, n=120):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    Y = rng.standard_normal((n, 3))
    X_obs = X + 0.01 * rng.standard_normal(X.shape)
    centers = bdata.grid_centers(4)
    edges = bdata.grid_edges(centers)
    return X, Y, X_obs, centers, edges


def test_loss_against_brute_force_dense_terms():
    X, Y, X_obs, centers, edges = setup()
    lab = np.argmin(((X[:, None] - centers[None]) ** 2).sum(-1), axis=1)
    blocks = [np.nonzero(lab == b)[0] for b in range(4)]
    deg = np.zeros(4, int)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    terms = [(1 - deg[b], blocks[b]) for b in range(4)]
    terms += [(1, np.concatenate([blocks[i], blocks[j]])) for i, j in edges]
    ll = dense_ll(X, Y, terms, 0.3, 0.01)
    prior = (-0.5 * np.sum(((X - X_obs) / 0.01) ** 2)
             - 0.5 * X.size * math.log(2 * math.pi * 0.01**2))
    got = ref.loss(torch.as_tensor(X), torch.as_tensor(Y), X_obs, 0.01, torch.as_tensor(centers),
                   torch.as_tensor(edges), ref.Kernel(0.3, 1.0, 0.01), grad=False)
    assert abs(got.value - (-(ll + prior))) <= 1e-10 * abs(ll + prior)


def test_gradient_against_finite_differences():
    X, Y, X_obs, centers, edges = setup(1, n=60)
    kern = ref.Kernel(0.3, 1.0, 0.01)
    args = (torch.as_tensor(Y), X_obs, 0.01, torch.as_tensor(centers), torch.as_tensor(edges), kern)
    g = ref.loss(torch.as_tensor(X), *args, grad=True).grad.numpy()
    h = 1e-6
    for k in (0, 7, 33, 101):
        Xp, Xm = X.copy(), X.copy()
        Xp.flat[k] += h
        Xm.flat[k] -= h
        # the partition of X itself, held fixed across the difference
        fd = (ref.loss(torch.as_tensor(Xp), *args, grad=False, label_X=torch.as_tensor(X)).value
              - ref.loss(torch.as_tensor(Xm), *args, grad=False, label_X=torch.as_tensor(X)).value
              ) / (2 * h)
        assert abs(fd - g[k]) <= 1e-5 * max(1.0, abs(g[k])), (k, fd, g[k])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-20, 0.0])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[4] == 0.0
    assert r[1] == 1.0  # halfway, to even
    assert r[2] == 1.0 + 2**-10
    assert r[3] == -3.0
    y = torch.randn(1000)
    rel = ((ref.round_tf32(y) - y).abs() / y.abs()).max()
    assert rel <= 2**-11 * (1 + 1e-6)


def test_control_is_coarser_than_float32():
    X, Y, X_obs, centers, edges = setup(2)
    args = (torch.as_tensor(Y), X_obs, 0.01, torch.as_tensor(centers), torch.as_tensor(edges),
            ref.Kernel(0.3, 1.0, 0.01))
    exact = ref.loss(torch.as_tensor(X), *args, grad=True)
    f32 = ref.loss(torch.as_tensor(X).float(), *args, grad=True, dtype=torch.float32)
    tf32 = ref.loss(torch.as_tensor(X).float(), *args, grad=True, dtype=torch.float32, tf32=True)
    def gap(r):
        return float(torch.linalg.vector_norm(r.grad - exact.grad)) / exact.ll_grad_norm

    assert gap(tf32) > 10 * gap(f32)
