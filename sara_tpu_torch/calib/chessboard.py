"""Chessboard corner detection for calibration.

Twin of ``sara_tpu/calib/chessboard.py``. Corner response, NMS, subpixel
refinement and the circular-profile x-corner test run as one device
program (``_corner_candidates``) whose outputs come to the host in one
transfer; the square-grid assembly (a BFS over the candidates on scipy's
``cKDTree``) and the squares fallback are host graph work, as in the twin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch import resolve_device
from sara_tpu_torch.image.differential import gradient, harris_cornerness
from sara_tpu_torch.image.filtering import gaussian_blur
from sara_tpu_torch.utils.host import fetch, put


@dataclass(frozen=True)
class ChessboardParams:
    sigma_d: float = 0.8
    sigma_i: float = 2.4
    kappa: float = 0.04
    capacity: int = 512
    profile_radius: float = 5.0
    profile_samples: int = 32
    nms_radius: int = 4


def _nms_mask(c: torch.Tensor, r: int) -> torch.Tensor:
    """Local maxima of ``c`` over a (2r+1)^2 window with lexicographic
    tie-breaking: strictly greater than the "later" neighbours ((dy, dx) >
    (0, 0)), >= the "earlier" ones, and positive. Exact ties (common on
    symmetric synthetic boards) then keep exactly one pixel, where a plain
    max-pool would keep both or neither. Each half-window is two max-pools
    over the -inf padded map (a max is exact in any order)."""
    H, W = c.shape
    pad = F.pad(c, (r, r, r, r), value=-math.inf)[None, None]
    rows = F.max_pool2d(pad, (r, 2 * r + 1), stride=1)[0, 0]   # r full rows
    row = F.max_pool2d(pad, (1, r), stride=1)[0, 0]            # r in a row
    late = torch.maximum(rows[r + 1:r + 1 + H, :W],
                         row[r:r + H, r + 1:r + 1 + W])
    early = torch.maximum(rows[:H, :W], row[r:r + H, :W])
    return (c > late) & (c >= early) & (c > 0)


def _bilinear(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """Bilinear samples of (H, W) ``img`` at clamped (yy, xx)."""
    H, W = img.shape
    yyc = torch.clamp(yy, 0.0, H - 1.0)
    xxc = torch.clamp(xx, 0.0, W - 1.0)
    y0 = torch.floor(yyc).to(torch.int64)
    x0 = torch.floor(xxc).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = yyc - y0
    fx = xxc - x0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def _corner_candidates(image: torch.Tensor, params: ChessboardParams):
    """Harris x-corner candidates + circular-profile validation, as one
    device program on ``image``'s device. Returns a dict of (K,) tensors
    x, y, score and mask (K = capacity; rows outside the mask are
    padding, and equal scores may come in another order than the
    twin's)."""
    H, W = image.shape
    dev = image.device
    c = harris_cornerness(image, params.sigma_d, params.sigma_i, params.kappa)
    is_max = _nms_mask(c, params.nms_radius)
    b = 8
    interior = torch.zeros((H, W), dtype=torch.bool, device=dev)
    interior[b:H - b, b:W - b] = True
    score = torch.where(is_max & interior, c,
                        torch.full_like(c, -math.inf)).reshape(-1)
    vals, idx = torch.topk(score, min(params.capacity, score.shape[0]))
    yi = idx // W
    xi = idx % W
    y = yi.to(torch.float32)
    x = xi.to(torch.float32)
    valid = torch.isfinite(vals)

    # Subpixel refinement on the cornerness surface (3x3 quadratic).
    offs = torch.arange(-1, 2, device=dev)
    yy = torch.clamp(yi[:, None] + offs, 0, H - 1)
    xx = torch.clamp(xi[:, None] + offs, 0, W - 1)
    patch = c[yy[:, :, None], xx[:, None, :]]
    gy = 0.5 * (patch[:, 2, 1] - patch[:, 0, 1])
    gx = 0.5 * (patch[:, 1, 2] - patch[:, 1, 0])
    hyy = patch[:, 2, 1] + patch[:, 0, 1] - 2 * patch[:, 1, 1]
    hxx = patch[:, 1, 2] + patch[:, 1, 0] - 2 * patch[:, 1, 1]
    hxy = 0.25 * (patch[:, 2, 2] - patch[:, 2, 0]
                  - patch[:, 0, 2] + patch[:, 0, 0])
    det = hxx * hyy - hxy * hxy
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18),
                      det)
    x = x + torch.clamp(-(hyy * gx - hxy * gy) / det, -1.0, 1.0)
    y = y + torch.clamp(-(hxx * gy - hxy * gx) / det, -1.0, 1.0)

    # Gradient-orthogonality subpixel refinement (cornerSubPix-style): at a
    # saddle every window gradient is orthogonal to the offset to the true
    # corner, so p = (sum w g g^T)^-1 (sum w g g^T q). Three steps, all K
    # candidates at once (the twin's fori_loop under vmap).
    gx_img, gy_img = gradient(gaussian_blur(image, 0.8))
    win = 4
    offr = torch.arange(-win, win + 1, dtype=torch.float32, device=dev)
    wg = torch.exp(-(offr ** 2) / (2.0 * (win / 2.0) ** 2))
    Wwin = wg[:, None] * wg[None, :]
    n = 2 * win + 1
    for _ in range(3):
        qx = (x[:, None, None] + offr[None, None, :]).expand(-1, n, n)
        qy = (y[:, None, None] + offr[None, :, None]).expand(-1, n, n)
        gxs = _bilinear(gx_img, qy, qx)
        gys = _bilinear(gy_img, qy, qx)
        a = torch.sum(Wwin * gxs * gxs, dim=(1, 2))
        bmix = torch.sum(Wwin * gxs * gys, dim=(1, 2))
        c2 = torch.sum(Wwin * gys * gys, dim=(1, 2))
        bx = torch.sum(Wwin * (gxs * gxs * qx + gxs * gys * qy), dim=(1, 2))
        by = torch.sum(Wwin * (gxs * gys * qx + gys * gys * qy), dim=(1, 2))
        det = a * c2 - bmix * bmix
        det = torch.where(torch.abs(det) < 1e-12,
                          torch.full_like(det, 1e-12), det)
        nx = (c2 * bx - bmix * by) / det
        ny = (a * by - bmix * bx) / det
        # Clamp the step so refinement cannot run away.
        x, y = (torch.clamp(nx, x - 2.0, x + 2.0),
                torch.clamp(ny, y - 2.0, y + 2.0))

    # Circular intensity profile: an x-corner alternates dark/light 4 times.
    sm = gaussian_blur(image, 1.0)
    S = params.profile_samples
    ang = torch.arange(S, dtype=torch.float32, device=dev) / S * 2 * math.pi
    px = x[:, None] + params.profile_radius * torch.cos(ang)[None, :]
    py = y[:, None] + params.profile_radius * torch.sin(ang)[None, :]
    prof = _bilinear(sm, py, px)                                  # (K, S)
    prof = prof - prof.mean(dim=1, keepdim=True)
    # X-corner test via circular harmonics: a quadrant pattern concentrates
    # its energy in the 2nd harmonic, an edge in the 1st, a blob in none.
    harm = torch.arange(1, 5, dtype=torch.float32, device=dev)
    ph = ang[None, :] * harm[:, None]                             # (4, S)
    cr = prof @ torch.cos(ph).T                                   # (K, 4)
    ci = prof @ torch.sin(ph).T
    energy = cr * cr + ci * ci
    e_tot = torch.sum(prof * prof, dim=1) * (S / 2.0) + 1e-12
    e2 = energy[:, 1]
    dominant = ((e2 > energy[:, 0]) & (e2 > energy[:, 2])
                & (e2 > energy[:, 3]) & (e2 > 0.35 * e_tot))
    # Balanced dark/light occupancy.
    frac_pos = (prof > 0).to(torch.float32).mean(dim=1)
    is_xcorner = dominant & (frac_pos > 0.25) & (frac_pos < 0.75)
    return {"x": x, "y": y, "score": vals, "mask": valid & is_xcorner}


def detect_chessboard_corners(image, params: ChessboardParams =
                              ChessboardParams(),
                              expected_size: tuple | None = None,
                              device: str | torch.device | None = None):
    """Detect and order chessboard inner corners.

    ``image`` is a (H, W) gray array in [0, 1]; the device program runs on
    ``device`` (None = the card; raises without one) and its candidates
    come to the host in one transfer. Returns (corners (rows, cols, 2)
    float array, ok flag). Ordering is row-major along the board's two
    lattice directions; None if no coherent grid was found.
    """
    g = np.asarray(image, np.float32)
    out = _corner_candidates(put(g, resolve_device(device)), params)
    m, xs, ys = fetch(out["mask"], out["x"], out["y"])
    xs, ys = xs[m], ys[m]
    if len(xs) < 4:
        return None, False
    pts = np.stack([xs, ys], axis=1)
    grid = _assemble_grid(pts)

    def _matches(g):
        return (g is not None and expected_size is not None
                and tuple(g.shape[:2]) in (tuple(expected_size),
                                           tuple(expected_size)[::-1]))

    if grid is None or (expected_size is not None and not _matches(grid)):
        # Fallback: edge-chain square reconstruction + square-graph
        # embedding, robust to the strong distortion that breaks the
        # linear-prediction BFS.
        from sara_tpu_torch.calib.squares import assemble_grid_from_squares

        grid2 = assemble_grid_from_squares(g, pts, device=device)
        if grid2 is not None and (expected_size is None or _matches(grid2)):
            grid = grid2
    if grid is None:
        return None, False
    if expected_size is not None and not _matches(grid):
        return grid, False
    return grid, True


def _assemble_grid(pts: np.ndarray):
    """Greedy lattice BFS: place corners on integer grid coordinates
    (host-side; reference: SquareReconstruction.hpp)."""
    from scipy.spatial import cKDTree

    n = len(pts)
    tree = cKDTree(pts)
    # Seed: the corner closest to the centroid.
    seed = int(np.argmin(np.linalg.norm(pts - pts.mean(axis=0), axis=1)))
    d, idx = tree.query(pts[seed], k=min(5, n))
    if len(idx) < 3:
        return None
    # Lattice basis: nearest neighbor -> e1; the neighbor most orthogonal
    # to e1 -> e2.
    e1 = pts[idx[1]] - pts[seed]
    best = None
    for j in idx[2:]:
        v = pts[j] - pts[seed]
        cosang = abs(np.dot(v, e1)) / (np.linalg.norm(v) * np.linalg.norm(e1))
        if best is None or cosang < best[0]:
            best = (cosang, v)
    if best is None or best[0] > 0.5:
        return None
    e2 = best[1]

    tol = 0.35 * min(np.linalg.norm(e1), np.linalg.norm(e2))
    coords = {seed: (0, 0)}
    frontier = [seed]
    used = {seed}
    basis = {seed: (e1.copy(), e2.copy())}
    while frontier:
        cur = frontier.pop()
        ci, cj = coords[cur]
        b1, b2 = basis[cur]
        for (di, dj, v) in ((1, 0, b1), (-1, 0, -b1), (0, 1, b2), (0, -1, -b2)):
            tgt = (ci + di, cj + dj)
            if tgt in coords.values():
                continue
            pred = pts[cur] + v
            dd, jj = tree.query(pred)
            if dd < tol and jj not in used:
                coords[jj] = tgt
                used.add(jj)
                frontier.append(jj)
                # Local basis update follows the measured step.
                step = pts[jj] - pts[cur]
                if di != 0:
                    basis[jj] = (step * di, b2)
                else:
                    basis[jj] = (b1, step * dj)

    if len(coords) < 4:
        return None
    ij = np.asarray(list(coords.values()))
    imin, jmin = ij.min(axis=0)
    imax, jmax = ij.max(axis=0)
    rows = imax - imin + 1
    cols = jmax - jmin + 1
    grid = np.full((rows, cols, 2), np.nan)
    for k, (i, j) in coords.items():
        grid[i - imin, j - jmin] = pts[k]
    if np.isnan(grid).any():
        # Incomplete lattice: return the largest complete sub-grid if any.
        return None
    return grid
