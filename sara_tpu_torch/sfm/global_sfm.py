"""Global (unordered) SfM: match pairs -> averaging -> triangulate -> BA.

Twin of ``sara_tpu/sfm/global_sfm.py``. A capability the reference only
reaches incrementally (its OdometryPipeline processes video frame by
frame); for unordered collections (BASELINE configs 4/5) the global
pipeline is:

  1. pairwise matching + per-pair essential RANSAC, pair by pair or in
     chunks of pairs over a view axis padded to a power of two,
  2. spectral rotation averaging over the epipolar graph
     (``sfm/rotation_averaging.py``),
  3. translation recovery: shared-track edge scales + a rigid Laplacian
     solve (``sfm/edge_scales.py``), else direction-only translation
     averaging,
  4. a pose-graph polish over the epipolar graph (``sfm/pose_graph_opt.py``),
  5. track building (native union-find) + batched multi-view DLT
     triangulation,
  6. global Schur-complement bundle adjustment (``ba``), or the
     keyframe/map-block partitioned BA (``ba/partitioned.py``), optionally
     with its blocks split over a ``torch.distributed`` device mesh.

Everything runs on ``device`` (None = the CUDA device; raises without
one) in float32, the reference's production precision; the DLT runs on
K-normalised coordinates. Every estimator draws from one
``torch.Generator`` (default: seed 0 on the device).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.ba import BAOptions, BAProblem, bundle_adjust
from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust
from sara_tpu_torch.core import lie
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.matching.brute_force import (MatchParams, _match_sets,
                                                 match_descriptors)
from sara_tpu_torch.ops.smallmat import assemble_blocks
from sara_tpu_torch.ransac.estimators import estimate_relative_pose
from sara_tpu_torch.sfm.edge_scales import (estimate_edge_scales,
                                            solve_centers_fixed_scales)
from sara_tpu_torch.sfm.pose_graph_opt import (PoseGraphProblem,
                                               optimize_pose_graph)
from sara_tpu_torch.sfm.rotation_averaging import average_rotations
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.utils.host import fetch, put


@dataclass(frozen=True)
class GlobalSfMConfig:
    match_ratio: float = 0.8
    rel_pose_samples: int = 500
    rel_pose_threshold_px: float = 4.0
    min_pair_inliers: int = 30
    # IRLS rounds of the projected translation-averaging solve; each round
    # is an exact dense (3n)x(3n) solve given the weights, so ~6 suffices.
    translation_iters: int = 6
    # LM pose-graph refinement over the epipolar graph between averaging
    # and triangulation (edge translations re-scaled by the averaged
    # baselines). 0 disables.
    pose_graph_iters: int = 15
    min_track_length: int = 2
    ba_options: BAOptions = field(default_factory=lambda: BAOptions(max_iters=30))
    # Pairs per chunk of the match + relative-pose stage. 0 keeps the
    # pair-by-pair path; > 0 stacks the keypoint sets once on the device
    # (view axis padded to a power of two) and runs chunks of pairs,
    # bringing each chunk's results over in one transfer.
    pair_chunk: int = 0
    # Keyframe/map-block partitioned BA (BASELINE config 5): > 0 splits the
    # final bundle adjustment into this many camera blocks solved as
    # batched dense-Schur sub-problems (ba/partitioned.py), optionally
    # split over a device mesh (``ba_mesh``). 0 = single global solve.
    ba_blocks: int = 0
    ba_sweeps: int = 3
    # Use shared-track depth-ratio edge scales for translation recovery
    # (sfm/edge_scales.py); falls back to direction-only averaging when
    # fewer than half the edges receive a scale constraint.
    edge_scale_translation: bool = True


def _pair_chunk_program(xy, desc, mask, ia, ib, generator, K,
                        ratio, threshold_px, num_samples, min_inliers):
    """Match + E-RANSAC for a chunk of image pairs as one batched program.

    xy/desc/mask: (V, N, ...) stacked keypoint tensors; ia/ib: the chunk's
    B pair indices (sequences of ints), with ``None`` for a padding slot,
    whose masks are all False so its row comes out unsuccessful. The chunk
    is matched as one batched GEMM over (B, N, 128) and its B relative
    poses are estimated together (one ``torch.multinomial`` draw from
    ``generator`` for all pairs), as the reference ``vmap``s the pair.
    Returns stacked per-pair (j, ok, inliers, success, R, t)."""
    dev = xy.device
    live = put(np.asarray([a is not None for a in ia]), dev)
    ia = put(np.asarray([0 if a is None else a for a in ia], np.int64), dev)
    ib = put(np.asarray([0 if b is None else b for b in ib], np.int64), dev)
    j, ok, _ = _match_sets(desc[ia], mask[ia] & live[:, None], desc[ib],
                           mask[ib] & live[:, None], ratio)
    xb = torch.gather(xy[ib], 1, j[..., None].expand(-1, -1, 2))
    res, R, t = estimate_relative_pose(
        generator, xy[ia], xb, ok, K, K, threshold_px=threshold_px,
        num_samples=num_samples, min_inliers=min_inliers)
    return j.to(torch.int32), ok, res.inliers & ok, res.success, R, t


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _translation_averaging_jit(ei: torch.Tensor, ej: torch.Tensor,
                               u_dirs: torch.Tensor, n: int, iters: int,
                               s_min: float = 1.0,
                               huber: float = 0.5) -> torch.Tensor:
    """Camera centers from pairwise unit baseline directions, EXACT inner
    solve (the reference's jitted program, same name).

    Joint (c, s) least squares: minimize sum_e w_e ||c_j - c_i - s_e u_e||^2
    subject to c_0 = 0 (translation gauge) and the FIXED scale gauge
    sum_e s_e = E. Eliminating each s_e in closed form under the gauge
    reduces the problem to an UNCONSTRAINED quadratic in c alone:

        sum_e w_e ||P_e (c_j - c_i)||^2
            + (sum_e u_e . (c_j - c_i) - E)^2 / sum_e w_e^-1,

    with P_e = I - u u^T — the Govindu projected Laplacian PLUS a rank-one
    total-length term that pins the scale. One (3n)x(3n) dense solve per
    IRLS round; ``iters`` counts Huber reweighting rounds.
    """
    ei, ej = ei.long(), ej.long()
    E = ei.shape[0]
    dt, dev = u_dirs.dtype, u_dirs.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    P = eye3[None] - u_dirs[:, :, None] * u_dirs[:, None, :]   # (E, 3, 3)
    # Rank-one scale term: g = incidence-assembled directions.
    g = (u_dirs.new_zeros((n, 3)).index_add_(0, ei, -u_dirs)
         .index_add_(0, ej, u_dirs)).reshape(-1)
    # Gauge c_0 = 0: zero out the first block row/col, identity there.
    mask = torch.cat([torch.zeros(3, dtype=dt, device=dev),
                      torch.ones(3 * (n - 1), dtype=dt, device=dev)])
    eyeN = torch.eye(3 * n, dtype=dt, device=dev)

    def solve(w):
        wP = w[:, None, None] * P
        L = assemble_blocks(n, [(ei, ei, wP), (ej, ej, wP), (ei, ej, -wP),
                                (ej, ei, -wP)])
        sw = torch.sum(1.0 / torch.clamp(w, min=1e-9))
        Lf = L + g[:, None] * g[None, :] / sw
        rhs = (E / sw) * g
        Lf = Lf * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        c = torch.linalg.solve_ex(Lf + 1e-8 * eyeN, rhs * mask)[0]
        return c.reshape(n, 3)

    w = u_dirs.new_ones((E,))
    c = solve(w)
    for _ in range(iters):
        d = c[ej] - c[ei]
        p = torch.sum(d * u_dirs, dim=-1)
        lam = (torch.sum(p) - E) / torch.sum(1.0 / torch.clamp(w, min=1e-9))
        s = p - lam / torch.clamp(w, min=1e-9)
        rn = torch.linalg.vector_norm(d - s[:, None] * u_dirs, dim=1)
        w = torch.clamp(huber / torch.clamp(rn, min=1e-9), max=1.0)
        c = solve(w)
    # Metric gauge for callers: median baseline length = s_min.
    base = torch.linalg.vector_norm(c[ej] - c[ei], dim=1)
    return c * (s_min / torch.clamp(_median(base), min=1e-12))


def _translation_averaging(n: int, edges: Sequence[Tuple[int, int]],
                           u_dirs: np.ndarray, iters: int = 50,
                           s_min: float = 1.0, device=None) -> np.ndarray:
    """Host wrapper over :func:`_translation_averaging_jit`, on ``device``
    (None = the CUDA device) in float32, the reference's production
    precision."""
    dev = resolve_device(device)
    ei = put(np.asarray([e[0] for e in edges], np.int64), dev)
    ej = put(np.asarray([e[1] for e in edges], np.int64), dev)
    u = put(np.asarray(u_dirs, np.float32), dev)
    return fetch(_translation_averaging_jit(ei, ej, u, n, iters, s_min))[0]


def _multiview_triangulate(P_mats: torch.Tensor, uv: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Batched multi-view DLT.

    P_mats: (T, V, 3, 4) per-track camera matrices (padded), uv: (T, V, 2)
    pixels, mask: (T, V). Returns (T, 3) points (masked rows contribute
    zero equations)."""
    r1 = uv[..., 0, None] * P_mats[..., 2, :] - P_mats[..., 0, :]  # (T,V,4)
    r2 = uv[..., 1, None] * P_mats[..., 2, :] - P_mats[..., 1, :]
    A = torch.cat([r1, r2], dim=-2)                           # (T, 2V, 4)
    # Row normalization: the DLT is f32-fragile without it when the camera
    # matrices carry pixel-scale entries (callers should ALSO pass
    # K-normalized cameras/coords — see run_global_sfm).
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                        min=1e-12)
    w = torch.cat([mask, mask], dim=-1).to(A.dtype)
    A = A * w[..., None]
    # The right singular vectors are the same with or without the full U;
    # the reduced SVD skips U's (2V)^2 block once 2V >= 4.
    _, _, Vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 4)
    X = Vt[..., -1, :]
    w4 = X[..., 3]
    w4 = torch.where(w4.abs() < 1e-12, torch.full_like(w4, 1e-12), w4)
    return X[..., :3] / w4[..., None]


def _so3_log_host(R: np.ndarray) -> np.ndarray:
    return lie.so3_log(torch.from_numpy(np.asarray(R, np.float64))).numpy()


def _so3_exp_host(w: np.ndarray) -> np.ndarray:
    return lie.so3_exp(torch.from_numpy(np.asarray(w, np.float64))).numpy()


def run_global_sfm(keypoint_sets: List[Keypoints], K: np.ndarray,
                   pairs: Optional[List[Tuple[int, int]]] = None,
                   config: GlobalSfMConfig = GlobalSfMConfig(),
                   generator: Optional[torch.Generator] = None,
                   ba_mesh=None, device=None):
    """Reconstruct an unordered image collection on ``device`` (None = the
    CUDA device; raises without one).

    Args:
      keypoint_sets: per-image fixed-capacity Keypoints (same capacity),
        moved to the device.
      K: shared (3, 3) intrinsics.
      pairs: image pairs to match (default: all pairs).
      generator: a ``torch.Generator`` on the device (default: seed 0).
      ba_mesh: a ``torch.distributed`` DeviceMesh with a "block" axis for
        the partitioned BA (``config.ba_blocks > 0``); every rank of it
        runs this call.

    Returns dict with R (V,3,3), t (V,3), points (P,3), tracker, ba_info.
    """
    dev = resolve_device(device)
    V = len(keypoint_sets)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if pairs is None:
        pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    keypoint_sets = [Keypoints(*(f.to(dev) for f in kp))
                     for kp in keypoint_sets]
    Kt = put(np.asarray(K, np.float32), dev)
    stage_t = {}
    _t0 = time.perf_counter()

    def _mark(name):
        nonlocal _t0
        now = time.perf_counter()
        stage_t[name] = now - _t0
        _t0 = now

    # Host copies of every view's pixels and responses: one transfer.
    host = fetch(*[k.xy for k in keypoint_sets],
                 *[k.response for k in keypoint_sets])
    xy_host, resp_host = host[:V], host[V:]

    # --- Stage 1+2: matching + relative poses over the pair list. ---
    tracker = FeatureTracker()
    for v in range(V):
        tracker.add_frame(keypoint_sets[v].capacity, resp_host[v])

    edges = []
    edge_R = []
    edge_t = []
    edge_feats = []

    def add_edge(a, b, R, t, fi, fj):
        edges.append((a, b))
        edge_R.append(R)
        edge_t.append(t / max(np.linalg.norm(t), 1e-12))
        edge_feats.append((fi, fj))
        tracker.add_matches(a, b, fi, fj)

    if config.pair_chunk > 0:
        # Chunked pair stage. The view axis is padded to a power-of-two
        # bucket (the reference's compile reuse as the collection grows);
        # padded views are all-masked-out and never indexed by real pairs.
        B = config.pair_chunk
        Vb = max(8, 1 << (V - 1).bit_length())
        pad_v = Vb - V

        def stack_pad(arrs):
            s = torch.stack(arrs)
            if pad_v:
                s = torch.cat([s, s.new_zeros((pad_v,) + s.shape[1:])])
            return s

        xy = stack_pad([k.xy for k in keypoint_sets])
        desc = stack_pad([k.descriptors for k in keypoint_sets])
        msk = stack_pad([k.mask for k in keypoint_sets])
        N = xy.shape[1]
        arange = np.arange(N)
        n_chunks = -(-len(pairs) // B)
        for ci, c0 in enumerate(range(0, len(pairs), B)):
            if ci % 20 == 0:
                print(f"  pair stage: chunk {ci}/{n_chunks}",
                      file=sys.stderr, flush=True)
            chunk = pairs[c0:c0 + B]
            pad = B - len(chunk)
            ia = [p[0] for p in chunk] + [None] * pad
            ib = [p[1] for p in chunk] + [None] * pad
            j, ok, inl, success, R, t = _pair_chunk_program(
                xy, desc, msk, ia, ib, generator, Kt,
                config.match_ratio, config.rel_pose_threshold_px,
                config.rel_pose_samples, config.min_pair_inliers)
            j, inl, success, R, t = fetch(j, inl, success, R, t)
            for bi, (a, b) in enumerate(chunk):
                if not success[bi]:
                    continue
                sel = inl[bi]
                add_edge(a, b, R[bi], t[bi], arange[sel].copy(),
                         j[bi][sel].copy())
    else:
        mp = MatchParams(ratio=config.match_ratio)
        for (a, b) in pairs:
            ka, kb = keypoint_sets[a], keypoint_sets[b]
            m = match_descriptors(ka, kb, mp, device=dev)
            res, R_rel, t_rel = estimate_relative_pose(
                generator, ka.xy, kb.xy[m.j.long()], m.mask, Kt, Kt,
                threshold_px=config.rel_pose_threshold_px,
                num_samples=config.rel_pose_samples,
                min_inliers=config.min_pair_inliers)
            success, inl, mm, mi, mj, R_rel, t_rel = fetch(
                res.success, res.inliers, m.mask, m.i, m.j, R_rel, t_rel)
            if not bool(success):
                continue
            inl = inl & mm
            add_edge(a, b, R_rel, t_rel, mi[inl], mj[inl])

    _mark("pair_stage")
    if len(edges) < V - 1:
        raise RuntimeError(
            f"epipolar graph too sparse: {len(edges)} edges for {V} views")
    out = _global_stages(V, K, config, dev, tracker, xy_host, edges, edge_R,
                         edge_t, edge_feats, _mark, ba_mesh)
    out["stage_times"] = stage_t
    return out


def _global_stages(V, K, config, dev, tracker, xy_host, edges, edge_R,
                   edge_t, edge_feats, _mark, ba_mesh=None):
    """Stages 3-6 of :func:`run_global_sfm` on the epipolar graph of the
    pair stage: rotation averaging, translation recovery, the pose-graph
    polish, tracks + triangulation and the global BA. ``_mark(name)`` is
    called at the end of each stage. Returns run_global_sfm's dict without
    its stage times."""
    # --- Stage 3: rotation averaging. ---
    ei_t = put(np.asarray([e[0] for e in edges], np.int64), dev)
    ej_t = put(np.asarray([e[1] for e in edges], np.int64), dev)
    R_abs = fetch(average_rotations(
        V, ei_t, ej_t, put(np.stack(edge_R).astype(np.float32), dev)))[0]
    R_avg_snapshot = R_abs.copy()
    _mark("rotation_averaging")

    # --- Stage 4: translation averaging. ---
    u_dirs = np.stack([-(R_abs[e[1]].T @ t) for e, t in zip(edges, edge_t)])
    # Per-edge baseline scales from shared-track depth ratios: direction-only
    # averaging is rank-deficient on flexible graphs (straight camera rows —
    # see sfm/edge_scales.py); with scales known the center solve is rigid.
    scales = estimate_edge_scales(edges, edge_R, edge_t, edge_feats,
                                  xy_host, np.asarray(K))
    covered = float(np.mean(scales != 1.0))
    if config.edge_scale_translation and covered >= 0.5:
        centers = solve_centers_fixed_scales(V, edges, u_dirs, scales)
        base = np.linalg.norm(centers[[e[1] for e in edges]]
                              - centers[[e[0] for e in edges]], axis=1)
        med = np.median(base[base > 0]) if (base > 0).any() else 1.0
        centers = centers / max(med, 1e-12)
    else:
        centers = _translation_averaging(V, edges, u_dirs,
                                         iters=config.translation_iters,
                                         device=dev)
    t_abs = np.stack([-R_abs[v] @ centers[v] for v in range(V)])
    centers_avg = centers.copy()
    _mark("translation_averaging")

    # --- Stage 4b: pose-graph polish over the epipolar graph. ---
    if config.pose_graph_iters > 0 and len(edges) >= V:
        E_n = len(edges)
        poses6 = np.concatenate([_so3_log_host(R_abs), t_abs], axis=1)
        rel = np.zeros((E_n, 6))
        ok_e = np.zeros(E_n, bool)
        rel_w = _so3_log_host(np.stack(edge_R))
        for k, ((a, b), tu) in enumerate(zip(edges, edge_t)):
            # Metric edge translation: unit direction scaled by the
            # averaged baseline length.
            s_e = float(np.linalg.norm(centers[b] - centers[a]))
            if s_e < 1e-9:
                continue
            rel[k, :3] = rel_w[k]
            rel[k, 3:] = s_e * tu
            ok_e[k] = True
        f32 = lambda a: put(np.asarray(a, np.float32), dev)    # noqa: E731
        prob_pg = PoseGraphProblem(
            poses=f32(poses6), edge_i=ei_t, edge_j=ej_t, rel_pose=f32(rel),
            weight=f32(np.ones(E_n)), edge_mask=put(ok_e, dev),
            pose_fixed=put(np.asarray([True] + [False] * (V - 1)), dev))
        out_pg, _info_pg = optimize_pose_graph(
            prob_pg, max_iters=config.pose_graph_iters)
        p6 = fetch(out_pg.poses)[0]
        R_abs = _so3_exp_host(p6[:, :3])
        t_abs = p6[:, 3:]
        _mark("pose_graph_polish")

    # --- Stage 5: tracks + multi-view triangulation. ---
    tracker.compute_tracks(config.min_track_length)
    members = tracker.track_members()
    track_ids = sorted(members.keys())
    if not track_ids:
        raise RuntimeError("no feature tracks")
    max_len = max(len(members[t][0]) for t in track_ids)
    T = len(track_ids)
    P_pad = np.zeros((T, max_len, 3, 4))
    uv_pad = np.zeros((T, max_len, 2))
    m_pad = np.zeros((T, max_len), bool)
    # K-normalized cameras and image coordinates: entries stay O(1), which
    # the float32 DLT needs for accurate triangulation.
    Kinv = np.linalg.inv(K)
    P_all = np.concatenate([R_abs, t_abs[:, :, None]], axis=2)
    for ti, tid in enumerate(track_ids):
        frames, feats = members[tid]
        for k, (f, ft) in enumerate(zip(frames, feats)):
            P_pad[ti, k] = P_all[f]
            xy = xy_host[f][ft]
            xyn = Kinv @ np.array([xy[0], xy[1], 1.0])
            uv_pad[ti, k] = xyn[:2] / xyn[2]
            m_pad[ti, k] = True
    X = fetch(_multiview_triangulate(
        put(P_pad.astype(np.float32), dev), put(uv_pad.astype(np.float32),
                                                dev), put(m_pad, dev)))[0]
    _mark("tracks_triangulation")

    # Cheirality / sanity filter.
    good_pt = np.isfinite(X).all(axis=1) & (np.linalg.norm(X, axis=1) < 1e3)
    for ti, tid in enumerate(track_ids):
        frames, _ = members[tid]
        z = np.einsum("ij,j->i", R_abs[frames[0]], X[ti]) + t_abs[frames[0]]
        if z[2] <= 0:
            good_pt[ti] = False

    # --- Stage 6: global BA. ---
    obs_cam, obs_pt, obs_uv = [], [], []
    kept = {}
    for ti, tid in enumerate(track_ids):
        if not good_pt[ti]:
            continue
        kept[ti] = len(kept)
        frames, feats = members[tid]
        for f, ft in zip(frames, feats):
            obs_cam.append(f)
            obs_pt.append(kept[ti])
            obs_uv.append(xy_host[f][ft])
    Xk = X[good_pt]
    pose_fixed = np.zeros(V, bool)
    pose_fixed[0] = True
    poses6 = np.concatenate([_so3_log_host(R_abs), t_abs], axis=1)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    f32 = lambda a: put(np.asarray(a, np.float32), dev)        # noqa: E731
    prob = BAProblem(
        poses=f32(poses6),
        points=f32(Xk),
        intrinsics=f32(intr),
        cam_idx=put(np.asarray(obs_cam, np.int32), dev),
        pt_idx=put(np.asarray(obs_pt, np.int32), dev),
        uv=f32(np.asarray(obs_uv)),
        obs_mask=put(np.ones(len(obs_cam), bool), dev),
        pose_fixed=put(pose_fixed, dev),
        point_fixed=put(np.zeros(len(Xk), bool), dev),
    )
    if config.ba_blocks > 0:
        # Its info is already on the host.
        out, ba_info = partitioned_bundle_adjust(
            prob, config.ba_blocks, config.ba_options,
            sweeps=config.ba_sweeps, mesh=ba_mesh)
        poses_out, points_out = fetch(out.poses, out.points)
    else:
        out, info = bundle_adjust(prob, config.ba_options)
        names = list(info)
        poses_out, points_out, *info_host = fetch(
            out.poses, out.points, *(info[k] for k in names))
        ba_info = dict(zip(names, info_host))
    _mark("bundle_adjustment")

    R_fin = _so3_exp_host(poses_out[:, :3])
    return {
        "R": R_fin,
        "t": poses_out[:, 3:],
        "points": points_out,
        "tracker": tracker,
        "num_edges": len(edges),
        "n_obs": len(obs_cam),
        "ba_problem": prob,
        "ba_info": ba_info,
        # Stage diagnostics.
        "edges": edges,
        "edge_R": edge_R,
        "edge_t": edge_t,
        "edge_feats": edge_feats,
        "R_averaged": R_avg_snapshot,
        "centers_averaged": centers_avg,
        "centers_polished": np.stack(
            [-R_abs[v].T @ t_abs[v] for v in range(V)]),
    }
