"""The seismic event-relocation dataset: loading, distances, metrics (a
copy of ``gprf_tpu/data/seismic.py``).

  * :func:`dist_deg` / :func:`dist_km` / :func:`dist_lld` - host-side
    great-circle distances.
  * :func:`load_data` - load ``sorted_isc.npy`` (ISC bulletin rows) from
    ``data_dir``, or make and save a synthetic catalog when it is absent,
    and sample (and cache as ``seismic_Y_*.npy``) Y from a Matern-3/2
    great-circle GP prior.
  * :func:`make_synthetic_catalog` - a synthetic ISC-style catalog
    (clustered epicenters along fault-like arcs, magnitude-dependent
    location uncertainties, Morton-sorted).

Row layout:
  [time, time_err, lon, lat, smaj, smin, strike, depth, depth_err]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gprf_torch.data.synthetic import sample_y
from gprf_torch.kernels.gpcov import GPCov
from gprf_torch.partition.morton import sort_morton

(
    COL_TIME,
    COL_TIMEERR,
    COL_LON,
    COL_LAT,
    COL_SMAJ,
    COL_SMIN,
    COL_STRIKE,
    COL_DEPTH,
    COL_DEPTHERR,
) = np.arange(9)

AVG_EARTH_RADIUS_KM = 6371.0


def dist_deg(loc1, loc2):
    """Great-circle distance in degrees between (lon, lat) pairs.

    >>> int(dist_deg((10,0), (20, 0)))
    10
    >>> int(dist_deg((10,0), (10, 45)))
    45
    >>> int(dist_deg((-78, -12), (-10.25, 52)))
    86
    >>> bool(dist_deg((132.86521, -0.45606493), (132.86521, -0.45606493)) < 1e-4)
    True
    >>> bool(dist_deg((127.20443, 2.8123965), (127.20443, 2.8123965)) < 1e-4)
    True
    """
    lon1, lat1 = loc1
    lon2, lat2 = loc2
    rlon1 = np.radians(lon1)
    rlat1 = np.radians(lat1)
    rlon2 = np.radians(lon2)
    rlat2 = np.radians(lat2)
    dist_rad = 2 * np.arcsin(
        np.sqrt(
            np.sin((rlat1 - rlat2) / 2.0) ** 2
            + np.cos(rlat1) * np.cos(rlat2) * np.sin((rlon1 - rlon2) / 2.0) ** 2
        )
    )
    return np.degrees(dist_rad)


def dist_km(loc1, loc2):
    """Great-circle distance in km between (lon, lat) pairs."""
    return np.radians(dist_deg(loc1, loc2)) * AVG_EARTH_RADIUS_KM


def dist_lld(x1, x2):
    """Combined surface+depth distance in km between (lon, lat, depth)
    triples."""
    d1 = dist_km((x1[0], x1[1]), (x2[0], x2[1]))
    d2 = x1[2] - x2[2]
    return np.sqrt(d1**2 + d2**2)


def dist_lld_rows(X1, X2):
    """Vectorized pointwise dist_lld over matching rows of two
    (lon, lat, depth) arrays."""
    X1 = np.asarray(X1, dtype=np.float64)
    X2 = np.asarray(X2, dtype=np.float64)
    rlon1, rlat1 = np.radians(X1[:, 0]), np.radians(X1[:, 1])
    rlon2, rlat2 = np.radians(X2[:, 0]), np.radians(X2[:, 1])
    hav = (
        np.sin((rlat1 - rlat2) / 2.0) ** 2
        + np.cos(rlat1) * np.cos(rlat2) * np.sin((rlon1 - rlon2) / 2.0) ** 2
    )
    d_surf = 2.0 * np.arcsin(np.minimum(np.sqrt(np.maximum(hav, 0.0)), 1.0)) * AVG_EARTH_RADIUS_KM
    d_depth = X1[:, 2] - X2[:, 2]
    return np.sqrt(d_surf**2 + d_depth**2)


def mad(X1, X2):
    """(mean, median) pointwise location error in km between two
    (lon, lat, depth) arrays."""
    dists = dist_lld_rows(X1, X2)
    return float(np.mean(dists)), float(np.median(dists))


def make_synthetic_catalog(n=12000, seed=0):
    """ISC-style event catalog with fault-like spatial structure.

    Events are placed along a handful of great arcs (subduction-zone style)
    in the western Pacific with along-arc jitter, magnitudes ~ exp
    distribution, location uncertainty smaj = 400 / 2**mb km, depths mixing
    shallow crustal and deep slab events.  Rows are Morton-sorted on
    (lon, lat).
    """
    rng = np.random.default_rng(seed)
    arcs = [
        # (lon0, lat0, lon1, lat1, weight): rough WPac arc segments
        (122.0, 24.0, 142.0, 35.0, 0.25),
        (142.0, 35.0, 155.0, 50.0, 0.2),
        (128.0, -3.0, 140.0, -5.0, 0.2),
        (120.0, -9.0, 130.0, -7.5, 0.15),
        (150.0, -5.0, 155.0, -10.0, 0.2),
    ]
    weights = np.array([a[4] for a in arcs])
    weights = weights / weights.sum()
    counts = rng.multinomial(n, weights)
    rows = []
    for (lon0, lat0, lon1, lat1, _), cnt in zip(arcs, counts):
        t = rng.uniform(size=cnt)
        lon = lon0 + t * (lon1 - lon0) + rng.normal(0, 0.7, cnt)
        lat = lat0 + t * (lat1 - lat0) + rng.normal(0, 0.7, cnt)
        mb = np.clip(3.0 + rng.exponential(0.8, cnt), 2.5, 6.5)
        err_km = 400.0 / np.exp(mb * np.log(2))
        smaj = err_km
        smin = err_km * rng.uniform(0.5, 1.0, cnt)
        strike = rng.uniform(0, 180, cnt)
        deep = rng.uniform(size=cnt) < 0.3
        depth = np.where(deep, rng.uniform(70, 600, cnt), rng.gamma(2.0, 10.0, cnt))
        depth_err = 0.05 * depth + 1.0
        time = rng.uniform(0, 3.15e8, cnt)  # ~a decade of seconds
        time_err = rng.uniform(0.1, 2.0, cnt)
        rows.append(
            np.column_stack(
                [time, time_err, lon, lat, smaj, smin, strike, depth, depth_err]
            )
        )
    cat = np.concatenate(rows, axis=0)
    sorted_ll, sorted_cat, _ = sort_morton(cat[:, [COL_LON, COL_LAT]], cat)
    return sorted_cat


def load_data(synth_lscale, seed, data_dir="."):
    """(sorted_isc, SY, cov): the seismic problem's inputs.

    Y is sampled from a Matern-3/2 GP prior over the great-circle distance
    with lengthscale ``synth_lscale`` km (float64, on the host), with the
    normal draws of ``RandomState(seed)`` (the stream the reference draws
    after ``np.random.seed(seed)``), and cached beside the catalog.  When
    ``sorted_isc.npy`` is absent a synthetic catalog is made and saved."""
    isc_path = os.path.join(data_dir, "sorted_isc.npy")
    if os.path.exists(isc_path):
        sorted_isc = np.load(isc_path)
    else:
        print("sorted_isc.npy not found; generating synthetic catalog")
        sorted_isc = make_synthetic_catalog()
        np.save(isc_path, sorted_isc)

    XX = sorted_isc[:, [COL_LON, COL_LAT, COL_DEPTH]].copy()
    cov = GPCov.create([1.0], [synth_lscale, synth_lscale], dfn_str="lld", wfn_str="matern32",
                       device="cpu", dtype=torch.float64)
    y_fname = os.path.join(data_dir, "seismic_Y_%.1f_%d.npy" % (synth_lscale, seed))
    try:
        SY = np.load(y_fname)
    except (IOError, OSError):
        SY = sample_y(XX, cov, 0.1, 50, sparse_lscales=6.0, rng=np.random.RandomState(seed))
        np.save(y_fname, SY)
        print("sampled Y, saved to", y_fname)
    return sorted_isc, SY, cov


def make_x_prior(means, prior_std):
    """Diagonal Gaussian prior on (lon, lat, depth) rows, normalized as the
    seismic driver does it."""
    means = np.asarray(means, dtype=np.float64)
    prior_std = np.asarray(prior_std, dtype=np.float64)

    def x_prior(X):
        X = np.asarray(X, dtype=np.float64)
        r = (X - means) / prior_std
        r2 = r / prior_std
        n = X.shape[0]
        ll = -0.5 * np.sum(r**2) - 0.5 * n * (
            3 * np.log(2 * np.pi) + np.sum(np.log(prior_std**2))
        )
        lderiv = -r2.reshape(X.shape)
        return ll, lderiv

    return x_prior
