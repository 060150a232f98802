"""Offline coordinate clustering — 1-D k-means and percentile binning in
numpy (port of ``layoutdm_tpu/tokenizer/clustering.py``, which the port
cannot import: ``layoutdm_tpu/tokenizer/__init__.py`` imports jax).

Replaces the sklearn KMeans of the reference (`bin/clustering_coordinates.py:1-71`,
`helpers/clustering.py:7-55`); fitted centers are stored as ``.npz`` (see
`tokenizer.bbox.load_kmeans_centers`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def kmeans_1d(
    x: np.ndarray,
    n_clusters: int,
    n_iter: int = 50,
    seed: int = 0,
) -> np.ndarray:
    """Fit 1-D k-means, return sorted centers (n_clusters,)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    rng = np.random.RandomState(seed)
    # k-means++-style spread init via quantiles (deterministic, good for 1-D)
    qs = (np.arange(n_clusters) + 0.5) / n_clusters
    centers = np.quantile(x, qs)
    # tiny jitter to break ties when data has few unique values
    centers = centers + 1e-9 * rng.randn(n_clusters)
    for _ in range(n_iter):
        # assignment by nearest center == interval membership for sorted centers
        centers = np.sort(centers)
        edges = (centers[1:] + centers[:-1]) / 2
        ids = np.searchsorted(edges, x)
        sums = np.bincount(ids, weights=x, minlength=n_clusters)
        cnts = np.bincount(ids, minlength=n_clusters)
        new = np.where(cnts > 0, sums / np.maximum(cnts, 1), centers)
        if np.allclose(new, centers):
            centers = new
            break
        centers = new
    return np.sort(centers).astype(np.float32)


def percentile_1d(
    x: np.ndarray, n_clusters: int, v_min: float = 0.0, v_max: float = 1.0
) -> np.ndarray:
    """Equal-mass binning (`helpers/clustering.py:17-43` semantics): bins are
    defined over the sorted unique values; each center is the mean of its
    bin's values.  Empty bins (fewer unique values than clusters) inherit
    the nearest non-empty center below them — a -1 sentinel would survive
    `load_kmeans_centers`'s ascending sort and occupy the LOWEST bins,
    making bogus centers queryable."""
    x = np.asarray(x, dtype=np.float64).reshape(-1).clip(v_min, v_max)
    u = np.sort(np.unique(x))
    thresholds = np.linspace(0.0, 1.0, n_clusters + 1)[:-1]
    thr = np.array([u[int(t * len(u))] for t in thresholds])
    ids = (thr[None, :] <= u[:, None]).sum(axis=1) - 1
    centers = np.full((n_clusters,), np.nan)
    for i in range(n_clusters):
        vals = u[ids == i]
        if len(vals) > 0:
            centers[i] = vals.mean()
    # forward/backward fill so every bin holds a real, in-range center
    last = None
    for i in range(n_clusters):
        if np.isnan(centers[i]):
            if last is not None:
                centers[i] = last
        else:
            last = centers[i]
    first = next((c for c in centers if not np.isnan(c)), 0.0)
    centers = np.where(np.isnan(centers), first, centers)
    return centers.astype(np.float32)


def fit_coordinate_clusters(
    bboxes: np.ndarray,
    n_clusters_list=(32,),
    method: str = "kmeans",
    max_points: int = 100_000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Fit per-coordinate clusters for every requested bin count.

    ``bboxes``: (N, 4) xywh in [0,1].  Returns ``{"x-32": centers, ...}``
    matching the key scheme of the reference pickle
    (`bin/clustering_coordinates.py:45-63`, subsample at `:49`).
    """
    rng = np.random.RandomState(seed)
    n = bboxes.shape[0]
    if n > max_points:
        bboxes = bboxes[rng.choice(n, max_points, replace=False)]
    out = {}
    for i, key in enumerate(("x", "y", "w", "h")):
        col = bboxes[:, i]
        for k in n_clusters_list:
            if method == "kmeans":
                out[f"{key}-{k}"] = kmeans_1d(col, k, seed=seed)
            elif method == "percentile":
                out[f"{key}-{k}"] = percentile_1d(col, k)
            else:
                raise NotImplementedError(method)
    return out
