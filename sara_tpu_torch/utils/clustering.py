"""1-D clustering (twin of ``sara_tpu/utils/clustering.py``; host NumPy)."""

from __future__ import annotations

import numpy as np


def cluster_1d(values: np.ndarray, gap: float):
    """Group sorted 1-D values into clusters split at gaps > ``gap``.

    Returns (labels (N,) in input order, cluster centers)."""
    v = np.asarray(values, float)
    order = np.argsort(v)
    sv = v[order]
    if len(sv) == 0:
        return np.zeros(0, int), np.zeros(0)
    breaks = np.nonzero(np.diff(sv) > gap)[0]
    lab_sorted = np.zeros(len(sv), int)
    for b in breaks:
        lab_sorted[b + 1:] += 1
    labels = np.empty(len(sv), int)
    labels[order] = lab_sorted
    k = lab_sorted[-1] + 1
    centers = np.asarray([v[labels == c].mean() for c in range(k)])
    return labels, centers
