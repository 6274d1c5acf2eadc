"""Synthetic experiment data container with priors, metrics, and caching
(mirror of ``gprf_tpu/data/sampled.py``).

Holds the true latents SX, GP-prior outputs SY, noise-corrupted observed
locations X_obs, the held-out test split, the partition (grid centers, or
RPC with replayable splits), the isotropic Gaussian prior on X, the error
metrics and the predictive scores (SMSE and MSLL of the block predictor
against a mean/std baseline, and the exact GP's test likelihood).  Datasets
cache to disk keyed by their generation parameters, under the reference's
key, as an ``.npz`` of arrays (the reference pickles its own class, which
only it can load; this package never opens a pickle).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gprf_torch.data.synthetic import sample_synthetic, sampler_suffix
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.fullgp import GP
from gprf_torch.model.gprf import GPRF
from gprf_torch.model.predict import train_block_predictor
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.partition.grid import Blocker
from gprf_torch.partition.rpc import cluster_rpc
from gprf_torch.utils.io import mkdir_p

_ARRAYS = ("SX", "SY", "Xtest", "Ytest", "X_obs")


def exp_base_dir() -> str:
    return os.environ.get("GPRF_EXPERIMENTS",
                          os.path.join(os.path.expanduser("~"), "gprf_experiments"))


class SampledData:
    def __init__(self, noise_var=0.01, n=30, ntrain=20, lscale=0.5, obs_std=0.05, yd=10, seed=1):
        Xfull, Yfull, cov = sample_synthetic(n=n, noise_var=noise_var, yd=yd, lscale=lscale,
                                             seed=seed)
        SX = Xfull[:ntrain, :]
        # a fresh stream of the same seed, as the reference re-seeds here
        X_obs = SX + np.random.RandomState(seed).randn(*SX.shape) * obs_std
        self._set(noise_var, n, ntrain, lscale, obs_std, cov, SX, Yfull[:ntrain, :],
                  Xfull[ntrain:, :], Yfull[ntrain:, :], X_obs)

    def _set(self, noise_var, n, ntrain, lscale, obs_std, cov, SX, SY, Xtest, Ytest, X_obs):
        self.noise_var, self.n, self.ntrain = float(noise_var), int(n), int(ntrain)
        self.lscale, self.obs_std = float(lscale), float(obs_std)
        self.cov = cov
        self.SX, self.SY, self.Xtest, self.Ytest, self.X_obs = SX, SY, Xtest, Ytest, X_obs
        self.block_idxs = None

    @classmethod
    def from_arrays(cls, SX, SY, Xtest, Ytest, X_obs, cov_row, lscale, obs_std):
        """A dataset from its arrays and its full cov row [nv, sv, l1, l2]
        (a cache file's contents, or another package's dataset)."""
        cov_row = np.asarray(cov_row, dtype=np.float64).reshape(-1)
        self = cls.__new__(cls)
        cov = GPCov.create(cov_row[1:2], cov_row[2:], "euclidean", "se", device="cpu",
                           dtype=torch.float64)
        arrays = [np.asarray(a, dtype=np.float64) for a in (SX, SY, Xtest, Ytest, X_obs)]
        self._set(cov_row[0], len(arrays[0]) + len(arrays[2]), len(arrays[0]), lscale, obs_std,
                  cov, *arrays)
        return self

    def cov_row(self) -> np.ndarray:
        """The generating covariance as a full row [nv, sv, l1, l2]."""
        return np.concatenate([[self.noise_var], self.cov.wfn_params.numpy(),
                               self.cov.dfn_params.numpy()])

    # ----- partitioning ----------------------------------------------------

    def set_centers(self, centers):
        self.centers = np.asarray(centers)
        b = Blocker(self.centers)
        self.block_idxs = b.block_clusters(self.X_obs)
        self.reblock = b.block_clusters
        self.neighbors = b.neighbors(diag_connections=True)

    def cluster_rpc(self, blocksize, rng: np.random.RandomState):
        """The RPC partition of X_obs into blocks of < blocksize points; the
        split tree stays in ``rpc_splits`` for the device engine's replay,
        and ``reblock`` replays it on the host.  The replay indexes the
        ntrain training rows, as the reference's does: on the test split
        (``prediction_error``) it raises IndexError there and here."""
        all_idxs = np.arange(self.ntrain)
        self.block_idxs, splits = cluster_rpc(self.X_obs, all_idxs, target_size=blocksize,
                                              rng=rng)
        self.rpc_splits = splits
        self.reblock = lambda X: cluster_rpc(X, all_idxs, target_size=blocksize,
                                             fixed_split=splits)[0]
        self.neighbors = None  # build_gprf discovers the edges at local_dist

    def build_gprf(self, X=None, cov=None, local_dist=1e-4, *, device: torch.device | str,
                   dtype: torch.dtype, ops: Ops = KERNEL_OPS):
        """GPRF over the current partition, on ``device`` at ``dtype``.

        ``cov`` may be a full [[nv, sv, l...]] row or None for the
        generating covariance; ``local_dist`` is the neighbor threshold
        (1.0 => local GPs)."""
        if X is None:
            X = self.X_obs
        if cov is None:
            cov_obj = self.cov
            noise_var = self.noise_var
        else:
            cov = np.asarray(cov)
            if cov.shape[0] != 1:
                raise ValueError(f"invalid cov params {cov}")
            noise_var = cov[0, 0]
            cov_obj = GPCov.create(cov[0, 1:2], cov[0, 2:], "euclidean", "se", device="cpu",
                                   dtype=torch.float64)
        return GPRF(X, Y=self.SY, block_fn=self.reblock, block_idxs=self.block_idxs, cov=cov_obj,
                    noise_var=noise_var, neighbor_threshold=local_dist,
                    neighbors=self.neighbors if local_dist < 1.0 else [],
                    device=device, dtype=dtype, ops=ops)

    # ----- error metrics ---------------------------------------------------

    def mean_distance(self, x):
        X = x.reshape(self.SX.shape)
        return float(np.mean(np.linalg.norm(X - self.SX, axis=1)))

    def mean_abs_err(self, x):
        return float(np.mean(np.abs(x - self.SX.flatten())))

    def median_abs_err(self, x):
        X = x.reshape(self.SX.shape)
        return float(np.median(np.sqrt(np.sum((X - self.SX) ** 2, axis=1))))

    def lscale_error(self, FC):
        return float(FC[0, 2]) / float(self.cov.dfn_params[0])

    # ----- priors ----------------------------------------------------------

    def _gaussian_prior(self, xx, flatobs):
        xx = np.asarray(xx)
        r = (xx - flatobs) / self.obs_std
        ll = -0.5 * np.sum(r**2) - 0.5 * len(xx) * np.log(2 * np.pi * self.obs_std**2)
        return ll, -(xx - flatobs) / (self.obs_std**2)

    def x_prior(self, xx):
        """Isotropic Gaussian prior ll + gradient on flattened X."""
        return self._gaussian_prior(xx, self.X_obs.flatten())

    def x_prior_block(self, i, xx):
        """The Gaussian X-prior restricted to block i's points."""
        return self._gaussian_prior(xx, self.X_obs[self.block_idxs[i]].flatten())

    def random_init(self, rng: np.random.RandomState, jitter_std=None):
        if jitter_std is None:
            jitter_std = self.obs_std
        return self.X_obs + rng.randn(*self.X_obs.shape) * jitter_std

    # ----- predictive scoring ----------------------------------------------

    def prediction_error_gp(self, x, *, device: torch.device | str, dtype: torch.dtype):
        """The exact GP's test log-likelihood at latents x, summed over the
        output columns (each column's posterior mean under one shared
        posterior covariance)."""
        XX = np.asarray(x).reshape(self.X_obs.shape)
        ntest = self.n - self.ntrain
        gp = GP(XX, self.SY, self.cov, self.noise_var, device=device, dtype=dtype)
        pred_cov = gp.covariance(self.Xtest, include_obs=True)
        _, logdet = np.linalg.slogdet(pred_cov)
        pred_prec = np.linalg.inv(pred_cov)
        R = self.Ytest - gp.predict(self.Xtest).reshape(self.Ytest.shape)  # [ntest, dy]
        quad = np.einsum("ti,ts,si->i", R, pred_prec, R)
        lly = -0.5 * quad - 0.5 * logdet - 0.5 * ntest * np.log(2 * np.pi)
        return float(np.sum(lly))

    def prediction_error(self, X=None, cov=None, local_dist=1.0, *, device: torch.device | str,
                         dtype: torch.dtype, ops: Ops = KERNEL_OPS):
        """(SMSE, MSLL_block, MSLL_diag) of the BCM predictor on the test
        split against the mean/std baseline, on ``device`` at ``dtype``."""
        gprf = self.build_gprf(X=X, cov=cov, local_dist=local_dist, device=device, dtype=dtype,
                               ops=ops)
        test_blocks = self.reblock(self.Xtest)
        predict_blocks = train_block_predictor(gprf)
        results = predict_blocks(test_blocks, self.Xtest, test_noise_var=self.noise_var)
        return self.score_predictions(test_blocks, results)

    def score_predictions(self, test_blocks, results):
        """(SMSE, MSLL_block, MSLL_diag) of per-test-block predictions
        {block: (mean, cov)}, on the host in float64."""
        def gaussian_ll(Y, M, C):
            ntest, yd = Y.shape
            P = np.linalg.inv(C)
            R = Y - M
            ll = -0.5 * np.sum(P * (R @ R.T))
            ll -= 0.5 * yd * np.linalg.slogdet(C)[1]
            ll -= 0.5 * yd * ntest * np.log(2 * np.pi)
            return ll

        ll_block = ll_block_diag = se_block = 0.0
        for t, idxs in enumerate(test_blocks):
            if len(idxs) == 0:
                continue
            Yt = self.Ytest[idxs]
            PM, PC = results[t]
            ll_block += gaussian_ll(Yt, PM, PC)
            ll_block_diag += gaussian_ll(Yt, PM, np.diag(np.diag(PC)))
            se_block += np.sum((Yt - PM) ** 2)

        ntest, yd = self.Ytest.shape
        Ymean = np.mean(self.SY, axis=0)
        smse = se_block / np.sum((self.Ytest - Ymean) ** 2)
        Ystd = np.std(self.SY, axis=0)
        ll_baseline = np.sum([np.sum(-0.5 * ((self.Ytest[:, i] - Ymean[i]) / Ystd[i]) ** 2
                                     - 0.5 * np.log(2 * np.pi * Ystd[i] ** 2))
                              for i in range(yd)])
        mll_baseline = ll_baseline / (ntest * yd)
        return (smse, ll_block / (ntest * yd) - mll_baseline,
                ll_block_diag / (ntest * yd) - mll_baseline)


def sample_data(n, ntrain, lscale, obs_std, yd, seed, centers, noise_var, rpc_blocksize=-1):
    """The dataset of these generation parameters, from its cache file under
    ``$GPRF_EXPERIMENTS/synthetic_datasets`` or sampled and cached, with its
    grid partition (``centers``) or, for ``centers=None``, its RPC
    partition of ``rpc_blocksize`` drawn from a stream seeded ``seed``."""
    sample_basedir = os.path.join(exp_base_dir(), "synthetic_datasets")
    mkdir_p(sample_basedir)
    # the reference's key with another extension: its .pkl holds an object
    # of its own class
    sample_fname = "%d_%d_%.6f_%.6f_%d_%d%s%s.npz" % (
        n, ntrain, lscale, obs_std, yd, seed,
        "" if noise_var == 0.01 else "_%.4f" % noise_var, sampler_suffix(n))
    path = os.path.join(sample_basedir, sample_fname)
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            sdata = SampledData.from_arrays(*(z[k] for k in _ARRAYS), z["cov_row"],
                                            float(z["lscale"]), float(z["obs_std"]))
    else:
        sdata = SampledData(n=n, ntrain=ntrain, lscale=lscale, obs_std=obs_std, seed=seed,
                            yd=yd, noise_var=noise_var)
        np.savez(path, cov_row=sdata.cov_row(), lscale=sdata.lscale, obs_std=sdata.obs_std,
                 **{k: getattr(sdata, k) for k in _ARRAYS})
    if centers is not None:
        sdata.set_centers(centers)
    else:
        sdata.cluster_rpc(rpc_blocksize, rng=np.random.RandomState(seed))
    return sdata
