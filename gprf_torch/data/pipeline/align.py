"""Waveform alignment by sliding normalized cross-correlation (a copy of
``gprf_tpu/data/pipeline/align.py``).

The sliding normalized cross-correlation :func:`my_xc` (a correlation and
a running-window norm in NumPy); on top of it pairwise alignment
(:func:`align`), patch extraction and coherency, randomized
coordinate-ascent alignment of many waveforms (:func:`align_waves`), and
KMeans clustering of event locations (sklearn, imported when called).
"""

from __future__ import annotations

import time

import numpy as np

# window geometry of the reference (align_seismic_waves.py:55-58)
WINDOW_START_IDX = 60   # 2s before IDC arrival at 20 Hz
WINDOW_END_IDX = 260    # 8s after (10 s window)
PATCH_LEN = 200
_T = np.linspace(-3.0, 10.0, 301)
ALIGN_PRIOR = -np.abs(_T) / 3.0
ASCENT_PRIOR = -np.abs(_T) / 1.0


def my_xc(a, b):
    """Sliding normalized cross-correlation of template a against b.

    r[i] = <a/|a|, b[i:i+m]/|b[i:i+m]|> for every alignment i
    (len(r) = len(b) - len(a) + 1).  Matches the reference weave kernel
    (``align_seismic_waves.py:24-36``).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m = len(a)
    n = len(b) - m + 1
    if n <= 0:
        return np.zeros((0,))
    a_normed = a / np.linalg.norm(a)
    cc = np.correlate(b, a_normed, mode="valid")
    # running window energy via cumulative sums
    csum2 = np.concatenate([[0.0], np.cumsum(b * b)])
    wnorm = np.sqrt(np.maximum(csum2[m:] - csum2[:-m], 1e-300))
    return cc / wnorm


def xcorr_valid(a, b):
    """(max correlation, offset, full surface) — reference lines 7-14."""
    xc = my_xc(a, b)
    offset = int(np.argmax(xc))
    return float(xc[offset]), offset, xc


def align(w1, w2):
    """Best relative alignment of two waveforms via their windows
    (reference lines 61-77)."""
    patch1 = w1[WINDOW_START_IDX:WINDOW_END_IDX]
    patch2 = w2[WINDOW_START_IDX:WINDOW_END_IDX]
    xc1 = my_xc(patch1, w2)
    xc2 = my_xc(patch2, w1)
    prior = ALIGN_PRIOR[: len(xc1)]
    align1 = int(np.argmax(xc1 + prior))
    align2 = int(np.argmax(xc2 + ALIGN_PRIOR[: len(xc2)]))
    xcmax1 = float(xc1[align1])
    xcmax2 = float(xc2[align2])
    adj1 = WINDOW_START_IDX - align1
    adj2 = WINDOW_START_IDX - align2
    return xcmax1, xcmax2, align1, align2, adj1, adj2


def extract_patches(waves, window_starts):
    """Mean-removed, unit-norm patches at the given window starts
    (reference lines 83-92)."""
    patches = []
    for w, ws in zip(waves, window_starts):
        start_idx = int(ws)
        patch = np.array(w[start_idx : start_idx + PATCH_LEN], dtype=np.float64)
        patch -= np.mean(patch)
        nrm = np.linalg.norm(patch)
        if nrm > 0:
            patch /= nrm
        patches.append(patch)
    return patches


def correlate_patches(patches):
    p = np.array(patches)
    P = p @ p.T
    return P - np.diag(np.diag(P))


def coherency(waves, window_idxs):
    """Mean pairwise patch correlation (reference lines 133-137)."""
    return float(np.mean(correlate_patches(extract_patches(waves, window_idxs))))


def offsets(ws):
    """All-pairs alignment statistics (reference lines 104-115)."""
    n = len(ws)
    out = [np.zeros((n, n)) for _ in range(6)]
    for i, w1 in enumerate(ws):
        for j, w2 in enumerate(ws[:i]):
            vals = align(w1, w2)
            for k in range(6):
                out[k][i, j] = vals[k]
    return tuple(out)


def correlation_surface(waves, window_idxs, i, xcmax, threshold=0.45):
    """Weighted total correlation surface for waveform i against all
    confidently-correlated patches (reference lines 121-131)."""
    patches = extract_patches(waves, window_idxs)
    w = waves[i]
    total_xc = np.zeros(301)
    for j, patch in enumerate(patches):
        if j == i or xcmax[i, j] <= threshold:
            continue
        xc = my_xc(patch, w)
        total_xc[: len(xc)] += xc * xcmax[i, j]
    return total_xc


def coordinate_ascent(waves, window_idxs, xcmax, threshold=0.4, rng=None):
    rng = rng or np.random
    perm = rng.permutation(len(waves))
    for i in perm:
        surface = correlation_surface(waves, window_idxs, i, xcmax=xcmax, threshold=threshold)
        window_idxs[i] = np.argmax(surface + ASCENT_PRIOR[: len(surface)])
    return window_idxs


def align_waves(waves, nruns=5, threshold=0.45, max_s=None, init_widxs=None, rng=None):
    """Randomized-restart coordinate-ascent alignment
    (reference lines 156-200).  Returns (best coherency, window indices)."""
    rng = rng or np.random
    xcmax1, xcmax2, *_ = offsets(waves)
    xcmax = np.max((xcmax1, xcmax2), axis=0)
    xcmax = xcmax + xcmax.T
    n = len(waves)

    def coord_ascent_run():
        widxs = np.ones((n,), dtype=float) * (85 + rng.randn() * 3) + rng.randn(n) * 5
        widxs = np.clip(widxs, 0, None)
        for _ in range(4):
            widxs = coordinate_ascent(waves, widxs, xcmax, threshold, rng=rng)
        return widxs, coherency(waves, widxs)

    best_c = 0.0
    best_widxs = init_widxs
    if best_widxs is not None:
        best_c = coherency(waves, best_widxs)
    t0 = time.time()
    for _ in range(nruns):
        widxs, c = coord_ascent_run()
        if c > best_c:
            best_c, best_widxs = c, widxs
        if max_s is not None and time.time() - t0 > max_s:
            break
    return best_c, best_widxs


def cluster_locations(lonlats, n_clusters, seed=0):
    """KMeans clustering of event epicenters (reference lines 208-226)."""
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=n_clusters, init="k-means++", n_init=2,
                max_iter=300, tol=1e-4, random_state=seed)
    km.fit(np.asarray(lonlats))
    return km.labels_
