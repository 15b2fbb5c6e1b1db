"""Trajectory evaluation: Umeyama similarity alignment + ATE.

Twin of ``sara_tpu/utils/metrics.py`` (NumPy only).

The reference has no quantitative trajectory evaluation (SURVEY.md §6); this
is the standard ATE-RMSE metric used to validate our odometry against ground
truth (BASELINE.md configs 2/3/5).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args: src, dst: (N, 3). Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray,
             align_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment."""
    if len(traj_est) < 3:
        return float("nan")
    s, R, t = umeyama_alignment(traj_est, traj_gt, align_scale)
    aligned = (s * (R @ traj_est.T)).T + t
    return float(np.sqrt(((aligned - traj_gt) ** 2).sum(axis=1).mean()))
