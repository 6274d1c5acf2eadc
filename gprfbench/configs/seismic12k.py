"""The seismic relocation of the paper (Moore & Russell 2015, sec. 5.2) as
the benchmark makes it, and its plain reference.  Plain PyTorch and NumPy:
nothing here imports the program or JAX (``gprfbench.data`` gives the
seed streams).

**The data.**  The catalog is the synthetic one the repository generates
when the ISC bulletin is absent (:func:`make_catalog`, a copy of the
program's ``make_synthetic_catalog`` at the configuration's
``assumed.catalog_seed``, Morton-sorted by a copy of ``sort_morton``).  Y
[n, dy] is an exact draw from the Matern-3/2 great-circle and depth prior
at lengthscales ``synth_lscale`` plus ``noise_var`` I, one float64 Cholesky
factor on the device (:func:`draw_y`), from ``--seed``.  Job j observes the
true locations through the noise of ``RandomState(job seed)`` scaled by
``obs_std`` x (0.01 deg, 0.01 deg, 1 km), the command line's own draw
(:meth:`SeismicProblem.x_obs`).

**The reference.**  For a fit that observed X_obs: a PD-tree over the
wrapped (lon, lat) of X_obs, built as the command line builds it
(:class:`PDTree`, a copy); the edges of block pairs whose largest
cross-correlation at X_obs exceeds ``threshold`` (:func:`edges_above`);
then at a point theta (scaled locations and the four log covariance
parameters) the partition by the tree's splits (:func:`traverse`), and the
paper's joint form

    ll = sum_{(i,j) in E} log N(Y_ij | 0, K_ij) - sum_i (|E_i| - 1) log N(Y_i | 0, K_i)

with each term a dense Cholesky factor of the great-circle and depth
Matern-3/2 kernel plus nv I, the location prior, the covariance prior, the
lengthscale penalty and the clamps (:func:`loss`); its gradient with
respect to the whole theta by autograd.  ``control=True`` computes the
terms in float32 with every matrix product's operands rounded to TF32.

**Departures from the published description, each where the program
departs the same way:**

- The partition and the edges are read at the program's float32 width:
  the traversal from theta cast to float32, with the tree's table in
  float32 and the program's arithmetic (a point within float32's reach of a
  split plane takes the program's side); the edge rule's distances in
  float32.  The tree itself is built in float64 on the host.
- The covariance prior N(c | (-2.3, 0, 3.6, 3.6), 1.5^2) carries no
  normalising constant, as the program's fused loss; the host driver's
  ``seismic_cov_prior`` adds 4 log(1.5 sqrt(2 pi)) to the loss.
- The lengthscale penalty exp(70 (log l_h - 5)) acts on the horizontal
  lengthscale alone, the signal variance is pinned at 1, and the clamps
  are nv <= 10 and 1 <= l <= 999 (km), as in the seismic driver.
- Coincident points take a zero derivative of the distance (the program's
  guarded derivative); this reference masks only a term's diagonal, where
  the distance is 0 by definition.
"""

import math
import os
import shutil
import tempfile
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from gprfbench.data import DATA, stream_seed

COL_LON, COL_LAT, COL_DEPTH = 2, 3, 7
EARTH_RADIUS_KM = 6371.0
COV_PRIOR_MEANS = (-2.3, 0.0, 3.6, 3.6)
COV_PRIOR_STD = 1.5
LOG_2PI = math.log(2.0 * math.pi)
SQRT3 = 1.7320508075688772


# ---- the catalog and Y ---------------------------------------------------------

def _spread_bits_2(x):
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def morton_order(X):
    """The stable order of 2-d points by their Z-order codes (21 bits a
    coordinate over the points' bounding box)."""
    X = np.asarray(X, dtype=np.float64)
    lo, hi = X.min(axis=0), X.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((X - lo) / span * (2**21 - 1)).astype(np.uint64)
    codes = _spread_bits_2(q[:, 0]) | (_spread_bits_2(q[:, 1]) << np.uint64(1))
    return np.argsort(codes, kind="stable")


def make_catalog(n: int, seed: int = 0):
    """[n, 9] ISC-style rows (time, time_err, lon, lat, smaj, smin, strike,
    depth, depth_err): events along five western-Pacific arcs with along-arc
    jitter, 30% deep slab events, Morton-sorted on (lon, lat)."""
    rng = np.random.default_rng(seed)
    arcs = [(122.0, 24.0, 142.0, 35.0, 0.25), (142.0, 35.0, 155.0, 50.0, 0.2),
            (128.0, -3.0, 140.0, -5.0, 0.2), (120.0, -9.0, 130.0, -7.5, 0.15),
            (150.0, -5.0, 155.0, -10.0, 0.2)]
    weights = np.array([a[4] for a in arcs])
    counts = rng.multinomial(n, weights / weights.sum())
    rows = []
    for (lon0, lat0, lon1, lat1, _), cnt in zip(arcs, counts):
        t = rng.uniform(size=cnt)
        lon = lon0 + t * (lon1 - lon0) + rng.normal(0, 0.7, cnt)
        lat = lat0 + t * (lat1 - lat0) + rng.normal(0, 0.7, cnt)
        mb = np.clip(3.0 + rng.exponential(0.8, cnt), 2.5, 6.5)
        smaj = 400.0 / np.exp(mb * np.log(2))
        smin = smaj * rng.uniform(0.5, 1.0, cnt)
        strike = rng.uniform(0, 180, cnt)
        deep = rng.uniform(size=cnt) < 0.3
        depth = np.where(deep, rng.uniform(70, 600, cnt), rng.gamma(2.0, 10.0, cnt))
        time_ = rng.uniform(0, 3.15e8, cnt)
        time_err = rng.uniform(0.1, 2.0, cnt)
        rows.append(np.column_stack([time_, time_err, lon, lat, smaj, smin, strike, depth,
                                     0.05 * depth + 1.0]))
    cat = np.concatenate(rows, axis=0)
    return cat[morton_order(cat[:, [COL_LON, COL_LAT]])]


def haversine_km(A, B):
    """Great-circle distances [p, q] in km between (lon, lat) degree rows."""
    a, b = torch.deg2rad(A), torch.deg2rad(B)
    lon1, lat1 = a[:, None, 0], a[:, None, 1]
    lon2, lat2 = b[None, :, 0], b[None, :, 1]
    hav = (torch.sin((lat1 - lat2) / 2.0) ** 2
           + torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon1 - lon2) / 2.0) ** 2)
    return 2.0 * torch.asin(torch.sqrt(torch.clamp(hav, 0.0, 1.0))) * EARTH_RADIUS_KM


def draw_y(X_true, lscale: float, noise_var: float, dy: int, g: torch.Generator):
    """Y [n, dy] ~ N(0, K(X_true) + noise_var I) in float64 on g's device, K
    the Matern-3/2 kernel of the great-circle and depth distance."""
    X = torch.as_tensor(X_true, dtype=torch.float64, device=g.device)
    r2 = haversine_km(X[:, :2], X[:, :2]) ** 2
    r2 += (X[:, None, 2] - X[None, :, 2]) ** 2
    r = torch.sqrt_(r2.div_(lscale**2)).mul_(SQRT3)
    K = (1.0 + r) * torch.exp(-r)
    del r, r2
    K.diagonal().add_(noise_var)
    L = torch.linalg.cholesky(K)
    del K
    return L @ torch.randn(X.shape[0], dy, generator=g, device=g.device, dtype=torch.float64)


def mad_km(X_true, X):
    """Mean great-circle and depth distance in km between matching rows."""
    X1, X2 = np.asarray(X_true, dtype=np.float64), np.asarray(X, dtype=np.float64)
    r1, r2 = np.radians(X1[:, :2]), np.radians(X2[:, :2])
    hav = (np.sin((r1[:, 1] - r2[:, 1]) / 2.0) ** 2
           + np.cos(r1[:, 1]) * np.cos(r2[:, 1]) * np.sin((r1[:, 0] - r2[:, 0]) / 2.0) ** 2)
    surf = 2.0 * np.arcsin(np.minimum(np.sqrt(np.maximum(hav, 0.0)), 1.0)) * EARTH_RADIUS_KM
    return float(np.mean(np.sqrt(surf**2 + (X1[:, 2] - X2[:, 2]) ** 2)))


# ---- the partition and the edges -------------------------------------------------

def wrap_lon(lon):
    """The partitioner's longitude wrap into [-22, 338)."""
    return (lon + 22.0) % 360.0 - 22.0


class PDTree:
    """Principal-direction tree over 2-d points: a set of ``minsize`` or
    more points splits at the median of its projection on the top
    eigenvector of its covariance (left: below the median).  The table
    holds per node (split_vec [2], center [2], split, left, right) in
    depth-first order, left first; ``leaves`` the members of each leaf at
    the build, in the same order, which numbers the blocks."""

    def __init__(self, X2, minsize: int):
        X2 = np.asarray(X2, dtype=np.float64)
        self.rows, self.leaves, self.leaf_of = [], [], {}
        self.depth = self._build(X2, np.arange(len(X2)), minsize, 0)
        self.table = np.array(self.rows)

    def _build(self, X2, idx, minsize, level):
        node = len(self.rows)
        self.rows.append(None)
        data = X2[idx] - np.mean(X2[idx], axis=0) if len(idx) >= minsize else None
        if data is not None:
            ev, evec = np.linalg.eigh(data.T @ data)
            vec = evec[:, np.argmax(ev)]
            a = data @ vec
            split = np.median(a)
            lo, hi = idx[a < split], idx[a >= split]
            if len(lo) and len(hi):
                dl = self._build(X2, lo, minsize, level + 1)
                right = len(self.rows)
                dr = self._build(X2, hi, minsize, level + 1)
                self.rows[node] = [*vec, *np.mean(X2[idx], axis=0), split, node + 1, right]
                return max(dl, dr)
        self.leaf_of[node] = len(self.leaves)
        self.leaves.append(idx)
        self.rows[node] = [0.0] * 5 + [node, node]
        return level

    def blocks(self, X2):
        """Each point's block [n] for (wrapped lon, lat) rows X2 [n, 2] at
        X2's dtype and device: the table at that dtype, a = (x - center) .
        split_vec summed over the two coordinates, left where a < split."""
        T = torch.as_tensor(self.table, dtype=X2.dtype, device=X2.device)
        leaf = torch.full((len(self.table),), -1, dtype=torch.int64, device=X2.device)
        for node, b in self.leaf_of.items():
            leaf[node] = b
        cur = torch.zeros(X2.shape[0], dtype=torch.int64, device=X2.device)
        for _ in range(self.depth):
            row = T[cur]
            a = torch.sum((X2 - row[:, 2:4]) * row[:, 0:2], dim=-1)
            cur = torch.where(a < row[:, 4], row[:, 5], row[:, 6]).long()
        return leaf[cur]


def traverse(tree: PDTree, X):
    """The blocks of locations X [n, 3] (lon, lat, depth) read at float32:
    the longitude wrapped in float32, then :meth:`PDTree.blocks`."""
    X32 = X.detach().to(torch.float32)
    lon = torch.remainder(X32[:, 0] + 22.0, 360.0) - 22.0
    return tree.blocks(torch.stack([lon, X32[:, 1]], dim=-1))


def matern32(r2):
    """(1 + sqrt(3) r) exp(-sqrt(3) r) of r = sqrt(r2)."""
    r = torch.sqrt(torch.clamp_min(r2, 0.0))
    return (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r)


def edges_above(tree: PDTree, X_obs, lscales, threshold: float, device):
    """[(i, j)], i > j: block pairs whose largest Matern-3/2 correlation
    between a point of i and one of j at X_obs exceeds ``threshold``, the
    distances at float32."""
    X = torch.as_tensor(np.asarray(X_obs), dtype=torch.float32, device=device)
    ls = torch.as_tensor(lscales, dtype=torch.float32, device=device)
    members = [torch.as_tensor(ix, device=device) for ix in tree.leaves]
    pairs, nearest = [], []
    for i in range(len(members)):
        Xi = X[members[i]]
        for j in range(i):
            Xj = X[members[j]]
            r2 = ((haversine_km(Xi[:, :2], Xj[:, :2]) / ls[0]) ** 2
                  + ((Xi[:, None, 2] - Xj[None, :, 2]) / ls[1]) ** 2)
            pairs.append((i, j))
            nearest.append(r2.min())
    if not pairs:
        return []
    corr = matern32(torch.stack(nearest)).cpu().numpy()
    return [p for p, k in zip(pairs, corr) if k > threshold]


# ---- the objective -----------------------------------------------------------------

def round_tf32(x):
    """x (float32) rounded to the nearest TF32 value (10 explicit mantissa
    bits, ties to even), kept in float32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's products
    likewise: what a TF32 tensor core computes."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.mT, a.mT @ g


def mm(a, b, tf32: bool):
    return _TF32Product.apply(a, b) if tf32 else a @ b


def kernel_matrix(Xt, nv, ls):
    """Matern-3/2 of the great-circle and depth distance among the rows of
    Xt [p, 3], plus nv I.  The diagonal's distance is 0 without passing
    through a square root, so its derivative is 0 there."""
    p = Xt.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=Xt.device)
    r = torch.deg2rad(Xt[:, :2])
    lon1, lat1 = r[:, None, 0], r[:, None, 1]
    lon2, lat2 = r[None, :, 0], r[None, :, 1]
    hav = (torch.sin((lat1 - lat2) / 2.0) ** 2
           + torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon1 - lon2) / 2.0) ** 2)
    hav = torch.where(eye, torch.full_like(hav, 0.25), hav)
    surf = torch.where(eye, torch.zeros_like(hav),
                       2.0 * torch.asin(torch.sqrt(hav)) * EARTH_RADIUS_KM)
    r2 = (surf / ls[0]) ** 2 + ((Xt[:, None, 2] - Xt[None, :, 2]) / ls[1]) ** 2
    r = torch.where(eye, torch.zeros_like(r2), torch.sqrt(torch.where(eye, 1.0, r2)))
    return (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r) + nv * eye.to(Xt.dtype)


def term_ll(Xt, Yt, nv, ls, tf32: bool):
    """log N(Yt | 0, K(Xt) + nv I) for Yt [p, dy], through one Cholesky
    factor."""
    p, dy = Yt.shape
    L = torch.linalg.cholesky(kernel_matrix(Xt, nv, ls))
    alpha = mm(torch.cholesky_inverse(L), Yt, tf32)
    return (-0.5 * torch.sum(Yt * alpha) - dy * torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * p * dy * LOG_2PI)


@dataclass
class Loss:
    value: float  # the loss, -(ll + priors)
    grad: torch.Tensor | None  # its gradient [ntheta], float64
    ll_grad_norm: float | None  # |d ll / d theta|, the scale of the gradient gap


@dataclass
class Fit:
    """What a fit's observations fix: the prior means, the tree and the
    edges."""

    X_obs: np.ndarray
    tree: PDTree
    edges: list


def make_fit(X_obs, config: dict, device) -> Fit:
    X_obs = np.asarray(X_obs, dtype=np.float64)
    tree = PDTree(np.stack([wrap_lon(X_obs[:, 0]), X_obs[:, 1]], axis=1),
                  config["rpc_blocksize"])
    ls = [config["synth_lscale"]] * 2
    return Fit(X_obs, tree, edges_above(tree, X_obs, ls, config["threshold"], device))


def prior_std(config: dict) -> np.ndarray:
    return config["obs_std"] * np.array([0.01, 0.01, 1.0])


def loss(theta, Y, fit: Fit, config: dict, *, task: str, grad: bool, control: bool = False
         ) -> Loss:
    """The loss at theta [ntheta] (float64 values; the program's, cast):
    scaled locations (depth / depth_scale) for tasks x and xcov, then for
    xcov the logs of (nv, sv, l_h, l_z).  With ``control`` the terms run in
    float32 with TF32 products; the sums, the priors and the gradient's
    assembly stay float64."""
    dev = Y.device
    n = fit.X_obs.shape[0]
    th = torch.as_tensor(np.asarray(theta, dtype=np.float64), device=dev).requires_grad_(grad)
    scale = torch.tensor([1.0, 1.0, config["depth_scale"]], dtype=torch.float64, device=dev)
    X = th[:3 * n].reshape(n, 3) * scale
    if task == "xcov":
        c = th[3 * n:]
        FC = torch.exp(c)
        nv = torch.clamp_max(FC[0], 10.0)
        ls = torch.clamp(FC[2:], 1.0, 999.0)
    else:
        c = None
        nv = torch.tensor(config["noise_var"], dtype=torch.float64, device=dev)
        ls = torch.tensor([config["synth_lscale"]] * 2, dtype=torch.float64, device=dev)

    labels = traverse(fit.tree, th[:3 * n].detach().reshape(n, 3))
    B = len(fit.tree.leaves)
    members = [torch.nonzero(labels == b).reshape(-1) for b in range(B)]
    degree = np.zeros(B, dtype=np.int64)
    for i, j in fit.edges:
        degree[i] += 1
        degree[j] += 1
    terms = [(1 - int(degree[b]), members[b]) for b in range(B)]
    terms += [(1, torch.cat([members[i], members[j]])) for i, j in fit.edges]
    wd = torch.float32 if control else torch.float64
    Xw, Yw, nvw, lsw = X.to(wd), Y.to(wd), nv.to(wd), ls.to(wd)
    ll = torch.zeros((), dtype=torch.float64, device=dev)
    for w, idx in terms:
        if w and idx.numel():
            ll = ll + w * term_ll(Xw[idx], Yw[idx], nvw, lsw, control).to(torch.float64)

    std = torch.as_tensor(prior_std(config), device=dev)
    r = (X - torch.as_tensor(fit.X_obs, device=dev)) / std
    prior = (-0.5 * torch.sum(r * r)
             - 0.5 * n * (3 * LOG_2PI + float(torch.sum(torch.log(std**2)))))
    if c is not None:
        rc = (c - torch.tensor(COV_PRIOR_MEANS, dtype=torch.float64, device=dev)) / COV_PRIOR_STD
        prior = prior - 0.5 * torch.sum(rc * rc)
        if float(c[2].detach()) > 5.0:
            prior = prior - torch.exp(70.0 * (c[2] - 5.0))
    value = float(-(ll + prior).detach())
    if not grad:
        return Loss(value, None, None)
    g_ll, = torch.autograd.grad(ll, th, retain_graph=True)
    g_prior, = torch.autograd.grad(prior, th)
    return Loss(value, -(g_ll + g_prior), float(torch.linalg.vector_norm(g_ll)))


# ---- the problem the harness runs ------------------------------------------------

class SeismicProblem:
    """One seed's data: the catalog's true locations, Y on the device and
    as the command line reads it from its data directory (``sorted_isc.npy``
    and ``seismic_Y_<lscale>_<seed>.npy``, linked into each fit's own
    directory by :meth:`data_dir`), each fit's observed locations, and the
    plain reference."""

    def __init__(self, config: dict, local_dist: float, seed: int, device: torch.device):
        if float(local_dist) != config["threshold"]:
            raise ValueError("the neighbor threshold is the configuration's threshold")
        self.config = config
        self.seed = int(seed)
        self.device = device
        catalog = make_catalog(config["n"], config["assumed"]["catalog_seed"])
        self.X_true = catalog[:, [COL_LON, COL_LAT, COL_DEPTH]].copy()
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, DATA))
        self.Y_dev = draw_y(self.X_true, config["synth_lscale"], config["noise_var"],
                            config["dy"], g)
        self.Y = self.Y_dev.cpu().numpy()
        self.cov_true = np.array([config["noise_var"], config["signal_var"],
                                  config["synth_lscale"], config["synth_lscale"]])
        self._dir = tempfile.mkdtemp(prefix="gprfbench-seismic-")
        weakref.finalize(self, shutil.rmtree, self._dir, True)
        np.save(os.path.join(self._dir, "sorted_isc.npy"), catalog)
        np.save(os.path.join(self._dir, "Y.npy"), self.Y)
        self._fits = {}

    def job_seed(self, *tag: int) -> int:
        """The command line's ``--seed`` of the fit of stream ``tag``: its
        observation noise, and its replicas' jitter."""
        return stream_seed(self.seed, *tag) % 2**31

    def x_obs(self, *tag: int) -> np.ndarray:
        """The observed locations [n, 3] of the fit of stream ``tag``
        (``(JOB, j)`` for job j, ``(WARM,)`` for the warm-up), drawn as the
        command line draws them from its ``--seed``."""
        noise = np.random.RandomState(self.job_seed(*tag)).randn(*self.X_true.shape)
        return self.X_true + noise * prior_std(self.config)

    def data_dir(self, root: str, job_seed: int) -> str:
        """A data directory under ``root`` in which the command line at
        ``--seed job_seed`` finds this seed's catalog and Y."""
        d = os.path.join(root, "data")
        os.makedirs(d, exist_ok=True)
        os.symlink(os.path.join(self._dir, "sorted_isc.npy"), os.path.join(d, "sorted_isc.npy"))
        os.symlink(os.path.join(self._dir, "Y.npy"),
                   os.path.join(d, "seismic_Y_%.1f_%d.npy" % (self.config["synth_lscale"],
                                                            job_seed)))
        return d

    def theta0(self, X_obs) -> np.ndarray:
        """The first replica's start: X_obs scaled, then the logs of the
        true covariance parameters for task xcov."""
        Xs = np.asarray(X_obs, dtype=np.float64).copy()
        Xs[:, 2] /= self.config["depth_scale"]
        parts = [Xs.reshape(-1)]
        if self.config["task"] == "xcov":
            parts.append(np.log(self.cov_true))
        return np.concatenate(parts)

    def fit_of(self, X_obs) -> Fit:
        key = np.asarray(X_obs, dtype=np.float64).tobytes()
        if key not in self._fits:
            self._fits = {key: make_fit(X_obs, self.config, self.device)}
        return self._fits[key]

    def mad(self, X) -> float:
        """Mean location error in km of X [n, 3] against the true locations."""
        return mad_km(self.X_true, np.asarray(X).reshape(self.X_true.shape))

    def ref_loss(self, X, X_obs, *, grad: bool, control: bool = False) -> Loss:
        """The reference at X: a theta [ntheta], or locations [n, 3] (a
        fit's start, at the true covariance parameters)."""
        X = np.asarray(X, dtype=np.float64)
        theta = self.theta0(X) if X.ndim == 2 else X
        return loss(theta, self.Y_dev, self.fit_of(X_obs), self.config,
                    task=self.config["task"], grad=grad, control=control)


def make_problem(config: dict, local_dist: float, seed: int, device: torch.device):
    return SeismicProblem(config, local_dist, seed, device)
