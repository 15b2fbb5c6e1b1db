"""Per-edge baseline scales from shared-track depth ratios (scale graph).

Twin of ``sara_tpu/sfm/edge_scales.py``: the port keeps its own copy of
this NumPy-only module (it imports nothing of the JAX package), held
equal to the original bit for bit by the tests.

Direction-only translation averaging cannot determine baseline lengths on
flexible view graphs: a straight camera row with parallel baselines (every
street sweep) satisfies all pairwise directions under ARBITRARY per-edge
spacing — the constraints are rank-deficient exactly along the trajectory
(measured: ATE 0.4-2.5 on EXACT directions of a 96-view boustrophedon
sweep, any solver). The missing metric information lives in the images:
two edges sharing a view that observe a common feature must assign it the
same metric depth, so the ratio of their baseline lengths equals the
inverse ratio of their unit-baseline triangulated depths.

Pipeline (host numpy; the arithmetic is tiny next to the pair stage):
  1. per-edge two-view depths of its inlier correspondences at unit
     baseline (closed-form 2-unknown least squares per point),
  2. for every (view, feature) seen by >= 2 edges, a log-ratio sample
     between each edge pair; per-pair MEDIAN over features (robust),
  3. least-squares log-scales over the edge-adjacency Laplacian
     (Jacobi-preconditioned CG, mean-zero gauge).

With per-edge scales s_e known, camera centers follow from ONE rigid
weighted-Laplacian solve: min sum_e w_e ||c_j - c_i - s_e u_e||^2 — well
posed on any connected graph, no collapse modes. (No reference
counterpart: oddkiva/sara has no global SfM; the technique follows the
baseline-ratio idea used by global-SfM literature, re-derived here.)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def two_view_depths(R: np.ndarray, t: np.ndarray, rays_a: np.ndarray,
                    rays_b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Depths (z_a, z_b) minimizing ||z_a R ra + t - z_b rb||^2 per point.

    R, t: relative pose of the pair (unit-norm t); rays_*: (M, 3) camera
    rays (K^-1 [x, y, 1]). Vectorized closed form (2x2 normal equations).
    """
    ra = rays_a @ R.T                       # (M, 3) rotated a-rays
    rb = rays_b
    aa = np.einsum("md,md->m", ra, ra)
    bb = np.einsum("md,md->m", rb, rb)
    ab = np.einsum("md,md->m", ra, rb)
    at = ra @ t
    bt = rb @ t
    det = aa * bb - ab * ab
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    z_a = (-bb * at + ab * bt) / det
    z_b = (-ab * at + aa * bt) / det
    return z_a, z_b


def estimate_edge_scales(edges: Sequence[Tuple[int, int]],
                         edge_R: Sequence[np.ndarray],
                         edge_t: Sequence[np.ndarray],
                         edge_feats: Sequence[Tuple[np.ndarray, np.ndarray]],
                         keypoints_xy: Sequence[np.ndarray],
                         K: np.ndarray,
                         min_shared: int = 3,
                         cg_iters: int = 200) -> np.ndarray:
    """Per-edge baseline scales (positive, geometric-mean 1).

    edge_feats[k] = (feat_ids_in_i, feat_ids_in_j) inlier correspondences
    of edge k; keypoints_xy[v] = (N, 2) pixel coords of view v.
    """
    E = len(edges)
    Kinv = np.linalg.inv(K)

    # 1. unit-baseline depths per edge endpoint.
    # depth_obs[(v, feat)] -> list of (edge, log z)
    per_vf: dict = {}
    for k, ((a, b), (fi, fj)) in enumerate(zip(edges, edge_feats)):
        if len(fi) == 0:
            continue
        xa = keypoints_xy[a][fi]
        xb = keypoints_xy[b][fj]
        ra = np.concatenate([xa, np.ones((len(xa), 1))], 1) @ Kinv.T
        rb = np.concatenate([xb, np.ones((len(xb), 1))], 1) @ Kinv.T
        z_a, z_b = two_view_depths(np.asarray(edge_R[k]),
                                   np.asarray(edge_t[k]), ra, rb)
        ok = (z_a > 1e-6) & (z_b > 1e-6)
        for f, z in zip(fi[ok], z_a[ok]):
            per_vf.setdefault((a, int(f)), []).append((k, np.log(z)))
        for f, z in zip(fj[ok], z_b[ok]):
            per_vf.setdefault((b, int(f)), []).append((k, np.log(z)))

    # 2. pairwise log-ratio samples -> per-edge-pair medians.
    samples: dict = {}
    # Pair CONSECUTIVE observations (a chain) rather than all-vs-obs[0]:
    # every edge pair along the chain contributes a constraint and no single
    # (possibly outlier) base observation contaminates all of a feature's
    # samples (advisor finding, round 4).
    for obs in per_vf.values():
        if len(obs) < 2:
            continue
        for (e1, lz1), (e2, lz2) in zip(obs, obs[1:]):
            if e1 == e2:
                continue
            key = (e1, e2) if e1 < e2 else (e2, e1)
            d = (lz2 - lz1) if e1 < e2 else (lz1 - lz2)
            samples.setdefault(key, []).append(d)

    pair_i, pair_j, pair_d, pair_w = [], [], [], []
    for (e1, e2), ds in samples.items():
        if len(ds) < min_shared:
            continue
        pair_i.append(e1)
        pair_j.append(e2)
        # log B_e1 - log B_e2 = log z^{e2} - log z^{e1}  (shared metric
        # depth B_e z^{e} equal across the two edges).
        pair_d.append(float(np.median(ds)))
        pair_w.append(float(min(len(ds), 50)))
    if not pair_i:
        return np.ones(E)
    pi = np.asarray(pair_i)
    pj = np.asarray(pair_j)
    pd = np.asarray(pair_d)
    pw = np.asarray(pair_w)

    # 3. CG on the weighted constraint Laplacian, x = log B (mean-zero).
    deg = np.zeros(E)
    np.add.at(deg, pi, pw)
    np.add.at(deg, pj, pw)
    rhs = np.zeros(E)
    np.add.at(rhs, pi, pw * pd)
    np.add.at(rhs, pj, -pw * pd)

    def matvec(x):
        y = deg * x
        d = x[pj] * pw
        np.add.at(y, pi, -d)
        d2 = x[pi] * pw
        np.add.at(y, pj, -d2)
        return y

    minv = 1.0 / np.maximum(deg, 1e-9)
    x = np.zeros(E)
    r = rhs - matvec(x)
    z = minv * r
    p = z.copy()
    rz = float(r @ z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        pAp = float(p @ Ap)
        if pAp <= 1e-18:
            break
        alpha = rz / pAp
        x += alpha * p
        r -= alpha * Ap
        if float(np.linalg.norm(r)) < 1e-10 * max(np.linalg.norm(rhs), 1):
            break
        z = minv * r
        rz_new = float(r @ z)
        p = z + (rz_new / max(rz, 1e-18)) * p
        rz = rz_new
    x -= x[deg > 0].mean() if (deg > 0).any() else 0.0
    # Edges with no ratio constraint get the connected bulk's gauge (1.0).
    x[deg <= 0] = 0.0
    return np.exp(np.clip(x, -8.0, 8.0))


def solve_centers_fixed_scales(n: int, edges: Sequence[Tuple[int, int]],
                               u_dirs: np.ndarray, scales: np.ndarray,
                               irls_iters: int = 4,
                               huber: float = 0.5) -> np.ndarray:
    """Camera centers with KNOWN per-edge baseline vectors s_e u_e: three
    independent scalar weighted-Laplacian solves (rigid for any connected
    graph), with Huber IRLS over edges. Gauge c_0 = 0."""
    ei = np.asarray([e[0] for e in edges])
    ej = np.asarray([e[1] for e in edges])
    tgt = scales[:, None] * u_dirs                 # (E, 3)
    w = np.ones(len(edges))
    c = np.zeros((n, 3))
    for _ in range(max(irls_iters, 1)):
        L = np.zeros((n, n))
        np.add.at(L, (ei, ei), w)
        np.add.at(L, (ej, ej), w)
        np.add.at(L, (ei, ej), -w)
        np.add.at(L, (ej, ei), -w)
        rhs = np.zeros((n, 3))
        np.add.at(rhs, ei, -w[:, None] * tgt)
        np.add.at(rhs, ej, w[:, None] * tgt)
        L[0, :] = 0.0
        L[:, 0] = 0.0
        L[0, 0] = 1.0
        rhs[0] = 0.0
        c = np.linalg.solve(L + 1e-9 * np.eye(n), rhs)
        rn = np.linalg.norm(c[ej] - c[ei] - tgt, axis=1)
        med = np.median(rn[rn > 0]) if (rn > 0).any() else 1.0
        w = np.minimum(1.0, huber * max(med, 1e-9) / np.maximum(rn, 1e-12))
    return c
