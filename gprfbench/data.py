"""The benchmark's data, made from ``--seed`` on the device: the true
latents SX, the observations Y (a draw from the configuration's GP prior),
the grid partition and its edges, and each job's noisy start X_obs.

Every stream comes from a ``torch.Generator`` on the device, seeded from
``(seed, tag)`` by NumPy's ``SeedSequence``, so that a seed gives the same
data whatever else ran before it.  Nothing here imports the program.

A configuration whose data or reference objective differ (another
partition, kernel or design) brings ``configs/<name>.py`` beside its JSON
file, with ``make_problem(config, local_dist, seed, device)`` returning an
object with the attributes and methods of :class:`Problem`, as a subclass
of it may; :func:`make_problem` finds it by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gprfbench import reference as ref
from gprfbench import spec

DATA, JOB, WARM, SAMPLE = 0, 1, 2, 3  # stream tags
RFF_CHUNK = 8192  # rows of the feature matrix at a time


def stream_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for the sub-stream ``tag`` of ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, *tag]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device: torch.device, seed: int, *tag: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *tag))
    return g


def grid_centers(nblocks: int) -> np.ndarray:
    """Centers [B, 2] of a ceil(sqrt(B))^2 grid over the unit square, in
    the order of ``gprfopt.py``'s ``grid_centers``."""
    pmax = int(np.ceil(np.sqrt(nblocks)) * 2 + 1)
    pts = np.linspace(0, 1, pmax)[1::2]
    return np.array([(xx, yy) for xx in pts for yy in pts], dtype=np.float64)


def grid_edges(centers: np.ndarray) -> np.ndarray:
    """Edges [E, 2], (i, j) with i > j, between blocks whose centers lie
    closer than the smallest diagonal distance (the grid with diagonal
    connections, the rule of the reference's ``Blocker.neighbors``): 342 on
    a 10 x 10 grid."""
    d = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    cc = d[d > 0]
    axis = cc.min() + 1e-6
    diag = cc[cc > axis].min() + 1e-6
    return np.array([(i, j) for i in range(len(centers)) for j in range(i) if d[i, j] < diag],
                    dtype=np.int64).reshape(-1, 2)


def se_kernel(A, B, lscale: float, signal_var: float):
    """sv exp(-|a - b|^2 / l^2), by differences (no matrix product)."""
    r2 = sum((A[:, None, k] - B[None, :, k]) ** 2 for k in range(A.shape[1]))
    return signal_var * torch.exp(-r2 / lscale**2)


def draw_y(SX, config: dict, g: torch.Generator):
    """Y [n, yd] ~ N(0, K(SX) + noise_var I), float64, on SX's device:
    ``exact`` by one Cholesky factor, ``rff`` by random Fourier features of
    the same kernel (``assumed.rff_features`` of them) plus the noise."""
    n, yd = SX.shape[0], config["yd"]
    lscale, sv, nv = config["lscale"], config["signal_var"], config["noise_var"]
    kind = config["assumed"]["y_draw"]
    dev, f64 = SX.device, torch.float64
    if kind == "exact":
        K = se_kernel(SX, SX, lscale, sv)
        K.diagonal().add_(nv)
        L = torch.linalg.cholesky(K)
        del K
        return L @ torch.randn(n, yd, generator=g, device=dev, dtype=f64)
    if kind != "rff":
        raise ValueError(f"unknown y_draw {kind!r}")
    D = int(config["assumed"]["rff_features"])
    # k(r) = sv exp(-|d|^2 / l^2) has spectral density N(0, 2 / l^2 I)
    omega = torch.randn(D, SX.shape[1], generator=g, device=dev, dtype=f64) * (
        math.sqrt(2.0) / lscale)
    phase = torch.rand(D, generator=g, device=dev, dtype=f64) * (2 * math.pi)
    W = torch.randn(D, yd, generator=g, device=dev, dtype=f64)
    noise = torch.randn(n, yd, generator=g, device=dev, dtype=f64)
    scale = math.sqrt(2.0 * sv / D)
    Y = torch.empty(n, yd, device=dev, dtype=f64)
    for s in range(0, n, RFF_CHUNK):
        Y[s:s + RFF_CHUNK] = torch.cos(SX[s:s + RFF_CHUNK] @ omega.T + phase) @ W * scale
    return Y + math.sqrt(nv) * noise


class Problem:
    """One seed's data: SX, Y, the centers and edges (host arrays, as the
    command line hands them to the program) and the job starts."""

    def __init__(self, config: dict, local_dist: float, seed: int, device: torch.device):
        self.config = config
        self.seed = int(seed)
        self.device = device
        g = generator(device, seed, DATA)
        n = config["ntrain"]
        self.SX_dev = torch.rand(n, config["dx"], generator=g, device=device,
                                 dtype=torch.float64)
        self.Y_dev = draw_y(self.SX_dev, config, g)
        self.SX = self.SX_dev.cpu().numpy()
        self.Y = self.Y_dev.cpu().numpy()
        self.centers = grid_centers(config["nblocks"])
        self.local_dist = float(local_dist)
        self.edges = (grid_edges(self.centers) if self.local_dist < 1.0
                      else np.zeros((0, 2), dtype=np.int64))

    def x_obs(self, *tag: int) -> np.ndarray:
        """A start X_obs = SX + obs_std N(0, 1) from the stream ``tag``
        (``(JOB, j)`` for job j, ``(WARM,)`` for the warm-up job)."""
        g = generator(self.device, self.seed, *tag)
        noise = torch.randn(self.SX_dev.shape, generator=g, device=self.device,
                            dtype=torch.float64)
        return (self.SX_dev + self.config["obs_std"] * noise).cpu().numpy()

    def mad(self, X) -> float:
        """Mean |X - SX| over coordinates (``SampledData.mean_abs_err``)."""
        return float(np.mean(np.abs(np.asarray(X).reshape(-1) - self.SX.reshape(-1))))

    def block_sizes(self, X) -> np.ndarray:
        """Points in each block of the nearest-center partition of X."""
        X = np.asarray(X)
        nearest = np.argmin(((X[:, None, :] - self.centers[None]) ** 2).sum(-1), axis=1)
        return np.bincount(nearest, minlength=len(self.centers))

    def ref_loss(self, X, X_obs, *, grad: bool, control: bool = False) -> ref.Loss:
        """The plain reference's loss at X (float64), or with ``control``
        the reference in TF32 at float32 (``reference.py``)."""
        cfg, dev = self.config, self.device
        kern = ref.Kernel(cfg["lscale"], cfg["signal_var"], cfg["noise_var"])
        return ref.loss(torch.as_tensor(X), self.Y_dev, X_obs, cfg["obs_std"],
                        torch.as_tensor(self.centers, device=dev), torch.as_tensor(self.edges),
                        kern, grad=grad, dtype=torch.float32 if control else torch.float64,
                        tf32=control)


def make_problem(cell, seed: int, device: torch.device):
    """The data of ``seed`` for ``cell``: its configuration's own
    ``make_problem`` where it has a module, else :class:`Problem`."""
    if cell.config_module is not None:
        module = spec.load_module(cell.config_module, "gprfbench_config_" + cell.config["name"])
        return module.make_problem(cell.config, cell.local_dist, seed, device)
    return Problem(cell.config, cell.local_dist, seed, device)
