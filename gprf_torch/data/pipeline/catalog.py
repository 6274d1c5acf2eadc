"""Catalog joining, outlier filtering, Morton sorting, cluster combining
(a copy of ``gprf_tpu/data/pipeline/catalog.py``).

Join the scraped ISC and IDC hypocenter tables by event id, drop events
whose bulletins disagree by more than 3x the reported uncertainty, sort by
the Morton order of (lon, lat) and write ``sorted_isc.npy``, the catalog
that :func:`gprf_torch.data.seismic.load_data` reads; and concatenate
per-cluster aligned-waveform artifacts.
"""

from __future__ import annotations

import os

import numpy as np

from gprf_torch.data.seismic import (
    COL_DEPTH,
    COL_LAT,
    COL_LON,
    COL_SMAJ,
    dist_lld,
)
from gprf_torch.partition.morton import sort_morton


def scraped_to_evid_dict(fname):
    """{evid: hypocenter-row} from a scraped CSV
    (reference ``seismic_util.py:6-13``; row = [idx, evid, fields...])."""
    d = {}
    with open(fname, "r") as f:
        for line in f:
            vals = [float(v) for v in line.split(",")]
            d[int(vals[1])] = vals[2:]
    return d


def join_and_sort(isc_dict, idc_dict):
    """Join by evid, filter outliers, Morton-sort
    (reference ``generate_sorted.py:15-41``).

    Returns (sorted_idc, sorted_isc, sorted_evids).
    """
    idc, isc, evids = [], [], []
    for evid in isc_dict.keys():
        if evid in idc_dict:
            idc.append(idc_dict[evid])
            isc.append(isc_dict[evid])
            evids.append(evid)
    idc = np.asarray(idc)
    isc = np.asarray(isc)
    evids = np.asarray(evids)
    n = len(idc)
    dists = np.asarray(
        [
            dist_lld(
                idc[i, (COL_LON, COL_LAT, COL_DEPTH)],
                isc[i, (COL_LON, COL_LAT, COL_DEPTH)],
            )
            for i in range(n)
        ]
    )
    inliers = dists < 3 * idc[:, COL_SMAJ]
    idc, isc, evids = idc[inliers], isc[inliers], evids[inliers]
    XX = idc[:, [COL_LON, COL_LAT]]
    _, sorted_idc, sorted_isc, sorted_evids, _ = sort_morton(XX, idc, isc, evids)
    return sorted_idc, sorted_isc, sorted_evids


def generate_sorted(isc_path, idc_path, out_dir="."):
    """End-to-end: scraped CSVs -> sorted_{idc,isc,evids}.npy
    (reference ``generate_sorted.py``)."""
    sorted_idc, sorted_isc, sorted_evids = join_and_sort(
        scraped_to_evid_dict(isc_path), scraped_to_evid_dict(idc_path)
    )
    np.save(os.path.join(out_dir, "sorted_idc.npy"), sorted_idc)
    np.save(os.path.join(out_dir, "sorted_isc.npy"), sorted_isc)
    np.save(os.path.join(out_dir, "sorted_evids.npy"), sorted_evids)
    return sorted_idc, sorted_isc, sorted_evids


def combine_clusters(clusters_dir, max_clusters=5000):
    """Concatenate per-cluster aligned artifacts into aligned_{X,Y,data}.npy
    (reference ``combine_clusters.py``)."""
    X, Y, data = [], [], []
    for i in range(max_clusters):
        x_path = os.path.join(clusters_dir, "cluster_%03d_X.npy" % i)
        if not os.path.exists(x_path):
            continue
        X.append(np.load(x_path))
        Y.append(np.load(os.path.join(clusters_dir, "cluster_%03d_Y.npy" % i)))
        data.append(np.load(os.path.join(clusters_dir, "cluster_%03d_Data.npy" % i)))
    X = np.vstack(X)
    Y = np.vstack(Y)
    data = np.vstack(data)
    np.save(os.path.join(clusters_dir, "aligned_X.npy"), X)
    np.save(os.path.join(clusters_dir, "aligned_Y.npy"), Y)
    np.save(os.path.join(clusters_dir, "aligned_data.npy"), data)
    return X, Y, data


def load_events(basedir, sta="mkar", bin_size=1000, max_bins=1000):
    """Load binned pickled (event, waveform) lists
    (reference ``seismic_util.py:19-32``): reads ``{sta}_stuff_{k*bin}``
    files until the ``_final`` sentinel."""
    import pickle

    s = []
    for i in range(1, max_bins):
        path = _os_join(basedir, "%s_stuff_%d" % (sta, i * bin_size))
        try:
            with open(path, "rb") as f:
                s += pickle.load(f)
        except (IOError, OSError):
            with open(_os_join(basedir, "%s_stuff_final" % sta), "rb") as f:
                s += pickle.load(f)
            break
    return s


def _os_join(*parts):
    return os.path.join(*parts)
