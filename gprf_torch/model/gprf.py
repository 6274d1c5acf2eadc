"""Host-facing GPRF model: a stateful wrapper over the objective (mirror of
``gprf_tpu/model/gprf.py``).

``llgrad``, ``update_X``, ``update_covs``, ``compute_neighbors``,
``subset_llgrad``, ``llgrad_unary`` / ``llgrad_joint`` and
``train_predictor`` keep the reference's
contracts, so the optimization driver and the analysis translate
one-to-one.  All compute is the batched objective
(:mod:`gprf_torch.model.objective`): the Schur form (``form="schur"``,
the default) or the joint form, the reference's parity oracle
(``form="joint"``), or with ``kernelized=True`` the second-moment
objective of :mod:`gprf_torch.model.kernelized`, over a padded
:class:`~gprf_torch.partition.layout.BlockLayout`; ``update_X`` replays the
partitioner's fixed splits on the host and uploads the gather tensors
again.  Wide batches are chunked under the reference's memory budget
(:func:`_auto_chunk`), which decides where the sums split.

The model computes on the ``device`` and at the ``dtype`` it is given and
decides nothing itself: the kernel wrappers launch their CUDA kernels on
float32 CUDA tensors and run their plain twins on CPU tensors.
``llgrad(sparse=True)`` is the exception: the truncated-support sparse
path (:mod:`gprf_torch.model.sparse_llgrad`) runs on the host in float64
whatever the model's device, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.model.kernelized import kernelized_value_and_grad
from gprf_torch.model.neighbors import compute_neighbors as _compute_neighbors
from gprf_torch.model.objective import (GPRFParams, gprf_value_and_grad,
                                        gprf_value_and_grad_schur)
from gprf_torch.model.predict import train_predictor
from gprf_torch.model.sparse_llgrad import gaussian_llgrad_sparse
from gprf_torch.ops.mvn import KERNEL_OPS, Ops
from gprf_torch.partition.layout import BlockLayout

_MB = 1024 * 1024


def _auto_chunk(n_items: int, width: int, budget_bytes: int = 512 * _MB) -> int | None:
    """The chunk of a batch of ``n_items`` [width, width] terms that keeps
    ~10 live float32 buffers of the chunk within the budget; None: the
    whole batch at once.  The reference's rule, kept exactly: it decides
    where the objective's sums split."""
    per_item = width * width * 4 * 10
    if n_items * per_item <= budget_bytes:
        return None
    return max(8, budget_bytes // per_item)


class GPRF:
    """Block-factored GP random field over latent inputs X and outputs Y.

    X : [n, dx] latent input locations (host NumPy; replaced by update_X)
    Y : [n, dy] observations, or with ``kernelized`` the [n, n] second
        moments Y Y^T of ``dy`` features (an array, or a tensor that may
        already sit on the device; put on the device once)
    block_fn : callable X -> list of index arrays (replayable partitioner),
        or None to freeze the initial partition
    cov : GPCov kernel hyperparameters
    noise_var : observation noise variance
    neighbor_threshold : max-correlation threshold for adding an edge
        (1.0 => no edges => independent local GPs)
    block_idxs / neighbors : optionally precomputed partition / edge list
    unary_chunk / pair_chunk : the chunks of the block and pair batches
        (default: :func:`_auto_chunk`; ``unary_chunk`` serves the joint form)
    form : "schur" (default) or "joint", the parity oracle
    device, dtype : where and at which width the objective is computed
    ops : the leaf primitives, the kernels (default) or their plain twins
    """

    def __init__(self, X, Y, block_fn, cov: GPCov, noise_var, kernelized: bool = False,
                 dy: int | None = None, nonstationary: bool = False,
                 neighbor_threshold: float = 1e-3, block_idxs=None, neighbors=None,
                 pad_multiple: int = 8, unary_chunk: int | None = None,
                 pair_chunk: int | None = None, form: str = "schur", mesh=None, *,
                 device: torch.device | str, dtype: torch.dtype, ops: Ops = KERNEL_OPS):
        if nonstationary:
            raise NotImplementedError("nonstationary GPRF is not supported (nor by gprf_tpu)")
        if kernelized and dy is None:
            raise ValueError("kernelized=True needs dy, the number of features behind YY")
        if form not in ("schur", "joint"):
            raise ValueError(f"unknown form {form!r}: 'schur' or 'joint'")
        if mesh is not None:
            raise NotImplementedError("multi-device llgrad is not ported yet (ROADMAP, still to "
                                      "port: parallel/sharding.py)")
        self.device = torch.device(device)
        self.dtype = dtype
        self.ops = ops
        self.X = np.asarray(X, dtype=np.float64).copy()
        self.kernelized = kernelized
        if kernelized:  # YY as given (an array, or a tensor that may sit on the device)
            self.dy = dy
            self.YY = Y
            self._Y_dev = torch.as_tensor(Y, dtype=dtype, device=self.device)
        else:
            self.Y = np.asarray(Y)
            self._Y_dev = torch.as_tensor(self.Y, dtype=dtype, device=self.device)
        self.cov = cov.to(device=self.device, dtype=dtype)
        self.noise_var = float(noise_var)
        self.block_fn = block_fn
        self.neighbor_threshold = float(neighbor_threshold)
        self.pad_multiple = pad_multiple
        self._unary_chunk = unary_chunk
        self._pair_chunk = pair_chunk
        self.form = form  # "schur": the default; "joint": the parity oracle

        if block_idxs is None:
            block_idxs = block_fn(self.X)
        self.n_blocks = len(block_idxs)
        self._pad_to = None  # set by the first layout build
        self._build_layout(block_idxs, edges=None)

        if neighbors is not None:
            self.neighbors = [(int(i), int(j)) for (i, j) in neighbors]
        else:
            self.neighbors = self.compute_neighbors(threshold=self.neighbor_threshold)
        self._set_edges(self.neighbors)

    # ----- layout management -------------------------------------------------

    def _build_layout(self, block_idxs, edges):
        layout = BlockLayout.from_blocks(block_idxs, n=len(self.X), edges=edges,
                                         pad_multiple=self.pad_multiple, pad_to=self._pad_to)
        self._pad_to = layout.block_pad
        self.layout = layout
        self._arrays = None  # uploaded again at the next use
        self._all_pairs_arrays = None

    def _set_edges(self, edges):
        self.neighbors = list(edges)
        self._build_layout(self.layout.block_idxs(), edges)
        self.neighbor_count = {i: int(c) for i, c in enumerate(self.layout.neighbor_count)}

    def _device_arrays(self):
        if self._arrays is None:
            self._arrays = self.layout.device_arrays(self.device, self.dtype)
        return self._arrays

    @property
    def block_idxs(self):
        return self.layout.block_idxs()

    # ----- reference API -----------------------------------------------------

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def compute_neighbors(self, threshold: float = 1e-3):
        """Edge discovery by batched max cross-correlation
        (:mod:`gprf_torch.model.neighbors`)."""
        arrays = self._device_arrays()
        return _compute_neighbors(self._tensor(self.X), arrays["assignment"], arrays["mask"],
                                  self.cov, threshold=threshold)

    def update_covs(self, covs):
        """Install a full cov row [[nv, sv, l1, l2, ...]]."""
        covs = np.asarray(covs, dtype=np.float64)
        self.cov = GPCov(wfn_params=self._tensor(covs[0, 1:2]), dfn_params=self._tensor(covs[0, 2:]),
                         dfn_str=self.cov.dfn_str, wfn_str=self.cov.wfn_str)
        self.noise_var = float(covs[0, 0])

    def update_X(self, new_X, update_blocks: bool = True, recompute_neighbors: bool = False):
        """Install new latent locations, replaying the partitioner's fixed
        splits.  A block that outgrows the padded slot count rebuilds the
        layout at the next multiple of ``pad_multiple``."""
        self.X = np.asarray(new_X, dtype=np.float64).copy()
        if update_blocks and self.block_fn is not None:
            block_idxs = self.block_fn(self.X)
            if max(len(ix) for ix in block_idxs) > self._pad_to:
                self._pad_to = None
            self._build_layout(block_idxs, self.neighbors)
        if recompute_neighbors:
            self._set_edges(self.compute_neighbors(threshold=self.neighbor_threshold))

    def update_X_block(self, i, new_X_block):
        idxs = self.layout.block_idxs()[i]
        self.X[idxs] = new_X_block

    def _value_and_grad(self, X, Y, arrays, grad_X, grad_cov):
        params = GPRFParams(X=self._tensor(X), wfn_params=self.cov.wfn_params,
                            dfn_params=self.cov.dfn_params,
                            noise_var=self._tensor(self.noise_var))
        common = dict(dfn_str=self.cov.dfn_str, wfn_str=self.cov.wfn_str, grad_X=grad_X,
                      grad_cov=grad_cov)
        if self.kernelized:  # no chunks: the reference evaluates every term at once
            ll, gX, gC = kernelized_value_and_grad(
                params, Y, arrays["assignment"], arrays["mask"], arrays["pair_assignment"],
                arrays["pair_mask"], arrays["unary_weights"], arrays["pair_weights"], self.dy,
                ops=self.ops, **common)
        elif self.form == "joint":
            ll, gX, gC = gprf_value_and_grad(
                params, Y, arrays["assignment"], arrays["mask"], arrays["pair_assignment"],
                arrays["pair_mask"], arrays["unary_weights"], arrays["pair_weights"],
                unary_chunk=self._unary_chunk_for(arrays),
                pair_chunk=self._pair_chunk_for(arrays), **common)
        else:
            ll, gX, gC = gprf_value_and_grad_schur(
                params, Y, arrays["assignment"], arrays["mask"], arrays["edges"],
                arrays["unary_weights"], arrays["pair_weights"], ops=self.ops,
                pair_chunk=self._pair_chunk_for(arrays), **common)
        # one transfer for the three results; float64 copies, since the
        # drivers add priors to them in place
        flat = torch.cat([ll.reshape(1).to(gX.dtype), gX.reshape(-1), gC.reshape(-1)])
        flat = flat.double().cpu().numpy()
        nX = gX.numel()
        return float(flat[0]), flat[1:1 + nX].reshape(gX.shape), flat[1 + nX:].reshape(gC.shape)

    def llgrad(self, grad_X: bool = False, grad_cov: bool = False, local: bool = True,
               parallel: bool = False, sparse: bool = False, max_distance: float = 5.0,
               **_ignored):
        """(ll, gradX, gradCov), as a float and float64 arrays.
        ``local=False`` uses the fully connected pairwise objective (all
        block pairs); ``parallel`` is accepted and ignored, the blocks are
        always batched.  ``sparse`` takes the host's truncated-support path
        (:meth:`_llgrad_sparse`, the kernel cut at ``max_distance`` scaled
        lengthscales)."""
        if sparse:
            return self._llgrad_sparse(grad_X, grad_cov, local, max_distance=max_distance)
        arrays = self._device_arrays() if local else self._all_pairs_device_arrays()
        return self._value_and_grad(self.X, self._Y_dev, arrays, grad_X, grad_cov)

    def _llgrad_sparse(self, grad_X, grad_cov, local, max_distance=5.0):
        """The truncated-support sparse objective: a host loop over the
        unary terms (weight 1 - count) and the pair terms, each through
        :func:`~gprf_torch.model.sparse_llgrad.gaussian_llgrad_sparse`
        (float64, the native sparse Cholesky and the selected inverse).
        ``local=False``: all block pairs."""
        if self.kernelized:
            raise ValueError("the sparse llgrad reads Y; a kernelized model holds only YY")
        if local:
            neighbors, counts = self.neighbors, self.neighbor_count
        else:
            B = self.n_blocks
            neighbors = [(i, j) for i in range(B) for j in range(i)]
            counts = {i: B - 1 for i in range(B)}
        blocks = self.layout.block_idxs()
        ll = 0.0
        gradX = np.zeros(self.X.shape)
        gradC = np.zeros((1, 2 + self.cov.dfn_params.numel()))
        terms = [(1 - counts.get(b, 0), idxs) for b, idxs in enumerate(blocks)]
        terms += [(1, np.concatenate([blocks[i], blocks[j]])) for i, j in neighbors]
        for w, idxs in terms:
            tll, tgX, tgC = gaussian_llgrad_sparse(
                self.X[idxs], self.Y[idxs], self.cov, self.noise_var, grad_X=grad_X,
                grad_cov=grad_cov, max_distance=max_distance)
            ll += w * tll
            if grad_X:
                gradX[idxs] += w * tgX
            if grad_cov:
                gradC[0] += w * tgC
        return float(ll), gradX, gradC

    def _unary_chunk_for(self, arrays):
        if self._unary_chunk is not None:
            return self._unary_chunk
        return _auto_chunk(*arrays["assignment"].shape)

    def _pair_chunk_for(self, arrays):
        """The pair chunk; by default from the budget at the stacked pair's
        width 2m, in both forms, as the reference chooses it."""
        if self._pair_chunk is not None:
            return self._pair_chunk
        return _auto_chunk(arrays["pair_assignment"].shape[0],
                           max(arrays["pair_assignment"].shape[-1], 1))

    def _all_pairs_device_arrays(self):
        if self._all_pairs_arrays is None:
            B = self.n_blocks
            edges = [(i, j) for i in range(B) for j in range(i)]
            layout = BlockLayout.from_blocks(self.layout.block_idxs(), n=len(self.X),
                                             edges=edges, pad_to=self._pad_to)
            self._all_pairs_arrays = layout.device_arrays(self.device, self.dtype)
        return self._all_pairs_arrays

    def subset_llgrad(self, blocks):
        """Objective restricted to a subset of blocks: unaries in the subset
        plus pairs within it, with subset-local neighbor counts."""
        block_set = set(int(b) for b in blocks)
        neighbors_in_set = [(i, j) for (i, j) in self.neighbors
                            if i in block_set and j in block_set]
        local_counts = {b: 0 for b in block_set}
        for i, j in neighbors_in_set:
            local_counts[i] += 1
            local_counts[j] += 1
        ll = 0.0
        for b in blocks:
            ll += (1 - local_counts[int(b)]) * self.llgrad_unary(int(b))[0]
        for i, j in neighbors_in_set:
            ll += self.llgrad_joint(i, j)[0]
        return ll

    # single-term entry points, mainly for tests and parity checks ----------

    def llgrad_unary(self, i, grad_X=False, grad_cov=False, **_):
        idxs = self.layout.block_idxs()[i]
        return self.gaussian_llgrad(self.X[idxs], self.Y[idxs], grad_X=grad_X, grad_cov=grad_cov)

    def llgrad_joint(self, i, j, grad_X=False, grad_cov=False, **_):
        blocks = self.layout.block_idxs()
        idxs = np.concatenate([blocks[i], blocks[j]])
        return self.gaussian_llgrad(self.X[idxs], self.Y[idxs], grad_X=grad_X, grad_cov=grad_cov)

    def gaussian_llgrad(self, X, Y, grad_X=False, grad_cov=False):
        """One dense Gaussian term, through the same batched code path (a
        batch of one full block, no edges)."""
        n = X.shape[0]
        if n == 0:
            return 0.0, np.zeros(X.shape), np.zeros((2 + self.cov.dfn_params.numel(),))
        one = BlockLayout.from_blocks([np.arange(n)], n=n, pad_to=n)
        ll, gX, gC = self._value_and_grad(X, self._tensor(Y),
                                          one.device_arrays(self.device, self.dtype),
                                          grad_X, grad_cov)
        return ll, gX, gC.reshape(-1)

    def train_predictor(self, test_cov=None, Y=None):
        """The BCM predictor over this model's blocks, trained at the
        current X (:func:`gprf_torch.model.predict.train_predictor`)."""
        return train_predictor(self, test_cov=test_cov, Y=Y)
