"""BCM-style prediction from a trained GPRF (mirror of
``gprf_tpu/model/predict.py``).

Each block is a local GP expert; a query is answered by the blocks that
hold the query points and their GPRF neighbors, combined in precision
space against the shared prior:

    message_prec_i = inv(post_cov_i) - inv(Kss)
    final_prec     = inv(prior_cov) + sum_i message_prec_i
    final_mean     = inv(final_prec) sum_i inv(post_cov_i) post_mean_i

The per-block training caches are (L, alpha): L the Cholesky factor of the
identity-padded block kernel, from K5 (``ops.cholesky`` through
:func:`gprf_torch.ops.split_mvn.cholesky_split`), and alpha = K^-1 Y by a
Cholesky solve.  Query-time products K*·K^-1·K*ᵀ are Cholesky solves
against the q query columns; no m x m inverse is ever formed.  The
combination runs batched on the device (``combine="device"``); the host
NumPy loop of the reference's shape stays as the parity oracle
(``combine="host"``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import scipy.linalg
import torch

from gprf_torch.kernels.covfn import cross_kernel_matrix, kernel_matrix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.kernels.hostnp import cross_kernel_matrix_np
from gprf_torch.linalg.masked import cholesky_nan, pad_kernel_matrix
from gprf_torch.ops.split_mvn import cholesky_split

# far-away query padding: each padded query sits this far apart from the
# others and from the data, so its SE cross-kernel underflows to exactly 0
_FAR = 1e5


def _block_caches(X, Y, assignment, mask, cov: GPCov, noise_var, ops):
    """Batched per-block (L, alpha) of X [n, dx], Y [n, dy] over the padded
    layout [B, m]: L [B, m, m] from K5 on the identity-padded block kernels,
    alpha [B, m, dy] = pad(K)^-1 Y_masked, zero on padded slots."""
    maskf = mask.to(X.dtype)
    Xb = X[assignment]
    Yb = Y[assignment] * maskf[..., None]
    Kp = pad_kernel_matrix(kernel_matrix(cov, Xb, noise_var), mask).contiguous()
    L = cholesky_split(Kp, ops=ops)
    alpha = torch.cholesky_solve(Yb, L) * maskf[..., None]
    return L, alpha


def symmetrize_neighbors(neighbors):
    ndict = defaultdict(set)
    for i, j in neighbors:
        ndict[i].add(j)
        ndict[j].add(i)
    return ndict


def _combine(Xq, Xs, Ls, Alphas, masks, model_cov: GPCov, test_cov: GPCov, expert_nv,
             prior_nv):
    """The BCM combination of T query sets at once.

    Xq [T, q, dx]; Xs [T, S, m, dx], Ls [T, S, m, m], Alphas [T, S, m, dy],
    masks [T, S, m]: each query set's S source experts.  Returns (mean
    [T, q, dy], cov [T, q, q]).  A dummy expert (all-zero mask, a valid
    factor) has Kstar = 0, so its posterior covariance is Kss bit for bit;
    its precision comes from the same batched factor and solve as the prior
    precision pp = inv(Kss), so its message prec - pp is exactly zero.  The
    prior uses ``test_cov``, the experts the model covariance; each
    expert's Kss takes ``expert_nv`` (the reference's quirk: the model noise
    whenever test noise is asked for)."""
    T, q = Xq.shape[:2]
    S = Xs.shape[1]
    eye = torch.eye(q, dtype=Xq.dtype, device=Xq.device)
    prior_cov = cross_kernel_matrix(test_cov, Xq, Xq) + eye * prior_nv
    Kss = cross_kernel_matrix(model_cov, Xq, Xq) + eye * expert_nv
    Kstar = cross_kernel_matrix(model_cov, Xq[:, None], Xs) * masks.to(Xq.dtype)[:, :, None, :]
    mean = Kstar @ Alphas  # [T, S, q, dy]
    # K*·K^-1·K*ᵀ by a Cholesky solve against the q columns: identity-padded
    # rows of L solve the masked (zero) Kstar columns to exact zeros
    cov_post = Kss[:, None] - Kstar @ torch.cholesky_solve(Kstar.mT, Ls)
    # the experts, pp and the prior precision in one batched factor and solve
    stacked = torch.cat([cov_post, Kss[:, None], prior_cov[:, None]], dim=1)
    precs = torch.cholesky_solve(eye.expand(stacked.shape), cholesky_nan(stacked))
    experts, pp, prior_prec = precs[:, :S], precs[:, S], precs[:, S + 1]
    final_prec = prior_prec + torch.sum(experts, dim=1) - S * pp
    final_cov = torch.linalg.inv_ex(final_prec)[0]
    final_mean = final_cov @ torch.sum(experts @ mean, dim=1)
    return final_mean, final_cov


def _snapshot(gprf, Y):
    """The (L, alpha) caches of ``gprf`` AS OF NOW, with the padded X and
    mask they belong to: a later ``update_X`` does not mix stale factors
    with fresh kernels."""
    arrays = gprf._device_arrays()
    X = gprf._tensor(gprf.X)
    Y = gprf._Y_dev if Y is None else gprf._tensor(Y)
    with torch.no_grad():
        Ls, Alphas = _block_caches(X, Y, arrays["assignment"], arrays["mask"], gprf.cov,
                                   gprf.noise_var, gprf.ops)
    return X[arrays["assignment"]], arrays["mask"], Ls, Alphas


def _finite_or_raise(mean, cov, what):
    if not (np.all(np.isfinite(mean)) and np.all(np.isfinite(cov))):
        # the host oracle's np.linalg.inv raises here; a Cholesky of a
        # singular expert posterior (coincident query points with
        # test_noise_var=0) gives NaN instead
        raise np.linalg.LinAlgError(f"BCM combination produced non-finite values{what}")


def train_block_predictor(gprf, test_cov: GPCov | None = None, Y=None):
    """Whole-test-set BCM prediction in one batched combination.

    The partition is the query structure: test block t is answered by the
    experts {t} + neighbors(t), so all T blocks pad to a common (qmax, Smax)
    and one :func:`_combine` answers every block.  Returns
    ``predict_blocks(test_blocks, Xtest, test_noise_var=0.0)`` -> dict
    {block_id: (mean [q_t, dy], cov [q_t, q_t])} for the non-empty blocks.
    Queries pad with far-away points whose SE cross-kernel underflows to
    exactly zero (euclidean distances only); sources pad with exact
    zero-message dummy experts.  Runs on the GPRF's device and at its
    dtype."""
    if gprf.cov.dfn_str != "euclidean":
        raise ValueError("batched block prediction pads queries with far points; only "
                         "euclidean kernels guarantee an exact cross-kernel underflow")
    test_cov = gprf.cov if test_cov is None else test_cov.to(device=gprf.device,
                                                               dtype=gprf.dtype)
    Xpad, mask, Ls, Alphas = _snapshot(gprf, Y)
    dx = gprf.X.shape[1]
    neighbor_dict = symmetrize_neighbors(gprf.neighbors)
    model_cov, noise_var = gprf.cov, gprf.noise_var

    def predict_blocks(test_blocks, Xtest, test_noise_var: float = 0.0):
        Xtest = np.asarray(Xtest)
        active = [t for t, idxs in enumerate(test_blocks) if len(idxs) > 0]
        T = len(active)
        if T == 0:
            return {}
        qmax = max(len(test_blocks[t]) for t in active)
        srcs = [sorted({t} | neighbor_dict[t]) for t in active]
        Smax = max(len(s) for s in srcs)
        Xq = np.zeros((T, qmax, dx))
        src_idx = np.zeros((T, Smax), dtype=np.int64)
        src_valid = np.zeros((T, Smax), dtype=bool)
        for a, t in enumerate(active):
            q = len(test_blocks[t])
            Xq[a, :q] = Xtest[np.asarray(test_blocks[t])]
            if q < qmax:
                Xq[a, q:] = Xq[a, 0]
                Xq[a, q:, 0] += _FAR * (1.0 + np.arange(qmax - q))
            src_idx[a, :len(srcs[a])] = srcs[a]
            src_valid[a, :len(srcs[a])] = True
        # padded source slots replay block 0 (a valid factor) with a zero mask
        idx = torch.as_tensor(src_idx, device=Ls.device)
        valid = torch.as_tensor(src_valid, device=Ls.device)
        expert_nv = noise_var if test_noise_var > 0 else 0.0
        with torch.no_grad():
            means, covs = _combine(gprf._tensor(Xq), Xpad[idx], Ls[idx], Alphas[idx],
                                   mask[idx] & valid[:, :, None], model_cov, test_cov,
                                   expert_nv, test_noise_var)
            flat = torch.cat([means.reshape(T, -1), covs.reshape(T, -1)], dim=1)
        flat = flat.double().cpu().numpy()  # one transfer for every block
        nm = means[0].numel()
        out = {}
        for a, t in enumerate(active):
            q = len(test_blocks[t])
            mean = flat[a, :nm].reshape(qmax, -1)[:q]
            cov = flat[a, nm:].reshape(qmax, qmax)[:q, :q]
            _finite_or_raise(mean, cov, f" for test block {t}")
            out[t] = (mean, cov)
        return out

    return predict_blocks


def train_predictor(gprf, test_cov: GPCov | None = None, Y=None, combine: str = "device"):
    """``predict(Xstar, test_noise_var=0.0, local=False)``: the combined
    posterior (mean, cov) over Y at the query locations Xstar, as float64
    NumPy arrays."""
    if combine not in ("device", "host"):
        raise ValueError(f"combine={combine!r}: 'device' or 'host'")
    test_cov = gprf.cov if test_cov is None else test_cov.to(device=gprf.device,
                                                               dtype=gprf.dtype)
    X_snap = np.array(gprf.X, copy=True)  # the X the caches belong to
    Xpad, mask, Ls, Alphas = _snapshot(gprf, Y)
    neighbor_dict = symmetrize_neighbors(gprf.neighbors)

    def _source_blocks(Xstar):
        # the partitioner on the query points: under an RPC partition its
        # replay indexes the training rows and raises IndexError for a
        # shorter query set, as gprf_tpu's does
        sources = set()
        for i, idxs in enumerate(gprf.block_fn(Xstar)):
            if len(idxs) > 0:
                sources.add(i)
                sources.update(neighbor_dict[i])
        return sorted(sources)

    if combine == "device":
        def predict(Xstar, test_noise_var: float = 0.0, local: bool = False):
            Xstar = np.asarray(Xstar)
            src = torch.as_tensor(_source_blocks(Xstar), dtype=torch.int64, device=Ls.device)
            expert_nv = gprf.noise_var if test_noise_var > 0 else 0.0
            with torch.no_grad():
                mean, cov = _combine(gprf._tensor(Xstar)[None], Xpad[src][None], Ls[src][None],
                                     Alphas[src][None], mask[src][None], gprf.cov, test_cov,
                                     expert_nv, test_noise_var)
            mean, cov = mean[0].double().cpu().numpy(), cov[0].double().cpu().numpy()
            _finite_or_raise(mean, cov, " (singular expert posterior? coincident query points "
                                        "with test_noise_var=0?)")
            return mean, cov

        return predict

    # the host-loop oracle, the reference's shape
    Ls_h = Ls.double().cpu().numpy()
    Alphas_h = Alphas.double().cpu().numpy()
    block_idxs = gprf.layout.block_idxs()
    sizes = gprf.layout.sizes
    dy = Alphas_h.shape[2]

    def predict(Xstar, test_noise_var: float = 0.0, local: bool = False):
        Xstar = np.asarray(Xstar)
        prior_cov = cross_kernel_matrix_np(test_cov, Xstar, Xstar)
        prior_cov = prior_cov + np.eye(len(Xstar)) * test_noise_var
        prior_prec = np.linalg.inv(prior_cov)
        prior_mean = np.zeros((Xstar.shape[0], dy))
        for i in _source_blocks(Xstar):
            nb = int(sizes[i])
            Xi = X_snap[block_idxs[i]]
            # identity padding is block-diagonal: the leading nb x nb of the
            # padded factor is chol(K_block), which solves with K_block where
            # the reference multiplies by the explicit inverse it cached
            Lb = Ls_h[i, :nb, :nb]
            alpha = Alphas_h[i, :nb]
            Kstar = cross_kernel_matrix_np(gprf.cov, Xstar, Xi)
            Kss = cross_kernel_matrix_np(gprf.cov, Xstar, Xstar)
            if test_noise_var > 0:
                # the reference's quirk: each expert's Kss gets the model
                # noise variance when test noise is asked for
                Kss = Kss + np.eye(Kss.shape[0]) * gprf.noise_var
            mean = Kstar @ alpha
            cov_post = Kss - Kstar @ scipy.linalg.cho_solve((Lb, True), Kstar.T)
            prec = np.linalg.inv(cov_post)
            pp = np.linalg.inv(Kss)
            prior_prec += prec - pp
            prior_mean += prec @ mean
        final_cov = np.linalg.inv(prior_prec)
        return final_cov @ prior_mean, final_cov

    return predict
