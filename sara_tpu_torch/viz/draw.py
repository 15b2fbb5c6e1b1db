"""Matplotlib drawing of features, matches, clouds, trajectories.

Twin of ``sara_tpu/viz/draw.py``: host code under the Agg backend
(matplotlib is imported inside each function). Images, keypoints, matches
and point arrays may be tensors on any device; they are copied to the
host.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """A numpy view of an array or a tensor (fetched from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_keypoints(image: np.ndarray, kp, path: str | None = None, ax=None):
    """Scale-circles + orientation ticks (reference:
    Visualization/Features/Draw.hpp)."""
    plt = _mpl()
    own = ax is None
    if own:
        fig, ax = plt.subplots(figsize=(10, 7))
    ax.imshow(_np(image), cmap="gray")
    m = _np(kp.mask)
    xy = _np(kp.xy)[m]
    sc = _np(kp.scale)[m]
    ori = _np(kp.orientation)[m]
    for (x, y), s, o in zip(xy, sc, ori):
        c = plt.Circle((x, y), max(s, 1.0), fill=False, color="y", lw=0.8)
        ax.add_patch(c)
        ax.plot([x, x + s * np.cos(o)], [y, y + s * np.sin(o)], "y-", lw=0.8)
    ax.set_axis_off()
    if own and path:
        plt.savefig(path, bbox_inches="tight", dpi=120)
        plt.close()
    return ax


def draw_matches(img_a, img_b, kp_a, kp_b, matches, path: str | None = None,
                 max_draw: int = 200):
    """Side-by-side match lines (reference: Visualization/Match/Draw.hpp:40-44,
    PairWiseDrawer)."""
    plt = _mpl()
    a = _np(img_a)
    b = _np(img_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1]), np.float32)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    fig, ax = plt.subplots(figsize=(14, 7))
    ax.imshow(canvas, cmap="gray")
    m = _np(matches.mask)
    i = _np(matches.i)[m][:max_draw]
    j = _np(matches.j)[m][:max_draw]
    xa = _np(kp_a.xy)[i]
    xb = _np(kp_b.xy)[j] + np.array([a.shape[1], 0.0])
    for p, q in zip(xa, xb):
        ax.plot([p[0], q[0]], [p[1], q[1]], "-", lw=0.6, alpha=0.7)
    ax.plot(xa[:, 0], xa[:, 1], "y.", ms=2)
    ax.plot(xb[:, 0], xb[:, 1], "y.", ms=2)
    ax.set_axis_off()
    if path:
        plt.savefig(path, bbox_inches="tight", dpi=120)
        plt.close()
    return ax


def draw_point_cloud(points: np.ndarray, colors=None, path: str | None = None,
                     elev=-60, azim=-90):
    """3-D scatter of the map (reference: Kalpana PointCloudScene)."""
    plt = _mpl()
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    p = _np(points)
    c = np.clip(_np(colors), 0, 1) if colors is not None else "steelblue"
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=1, c=c)
    ax.view_init(elev=elev, azim=azim)
    if path:
        plt.savefig(path, bbox_inches="tight", dpi=120)
        plt.close()
    return ax


def draw_trajectory(centers: np.ndarray, gt: np.ndarray | None = None,
                    path: str | None = None):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    c = _np(centers)
    ax.plot(c[:, 0], c[:, 2], "o-", label="estimated", ms=3)
    if gt is not None:
        g = _np(gt)
        ax.plot(g[:, 0], g[:, 2], "x--", label="ground truth", ms=3)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.axis("equal")
    ax.legend()
    if path:
        plt.savefig(path, bbox_inches="tight", dpi=120)
        plt.close()
    return ax
