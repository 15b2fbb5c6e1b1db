"""Stage by stage, the global SfM's ATE on the ring scene, on the PyTorch /
CUDA port (ROADMAP F4: 500 ring views fail in both packages).

Twin of ``scripts/probe_sfm_ate_stages.py``. It bypasses the pair stage:
the ring's ground-truth poses give noisy relative-pose edges directly (the
probe's ``RandomState`` draws, each noise rotation through ``so3_exp`` in
the working dtype), then each downstream stage of the port runs in turn
and its error against the ground truth is printed per view count:

- rotation averaging (``sfm/rotation_averaging.py::average_rotations``),
  its per-view error after the global gauge alignment;
- translation averaging (``sfm/global_sfm.py::_translation_averaging_jit``,
  50 Huber rounds), the ATE of its centres;
- the pose-graph polish (``sfm/pose_graph_opt.py::optimize_pose_graph``, 15
  iterations), the ATE of its centres;
- with ``--full``, the multi-view triangulation of the synthetic tracks
  (``_multiview_triangulate``) and ``--ba-rounds`` rounds of
  ``bundle_adjust``.

The stage whose error jumps between 128 and 512 views is the one that
breaks. Float32 by default, the reference's production precision (the
probe runs JAX without x64); ``--dtype float64`` for the exact solve.

It imports only ``sara_tpu_torch`` and numpy, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_sfm_ate_stages.py [--views 128 256 512]
       [--window 3] [--noise-deg 0.3] [--seed 0] [--full] [--ba-rounds 1]
       [--ba-iters 40] [--dtype float32] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def ring_poses(n_views):
    """The ring scene's world-to-camera rotations and centres, each camera
    looking at the origin."""
    Rs, cs = [], []
    for f in range(n_views):
        ang = 2 * np.pi * f / n_views
        c = np.array([18.0 * np.cos(ang), 2.0 * np.sin(3 * ang),
                      18.0 * np.sin(ang)])
        z = -c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0])
        xax = np.cross(up, z)
        xax /= np.linalg.norm(xax)
        yax = np.cross(z, xax)
        Rs.append(np.stack([xax, yax, z]))
        cs.append(c)
    return np.stack(Rs), np.stack(cs)


def _umeyama(X, Y):
    """Similarity (s, R, t) with Y ~ s * X @ R + t."""
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    U, S, Vt = np.linalg.svd(Xc.T @ Yc / len(X))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / (Xc ** 2).mean(0).sum()
    t = my - s * (mx @ R)
    return s, R, t


def rot_noise(rs, deg, dtype):
    """A rotation of ``rs``' normal angle-axis (``deg`` degrees of spread),
    through the port's ``so3_exp`` in ``dtype`` on the host."""
    import torch

    from sara_tpu_torch.core import lie

    w = rs.normal(scale=np.radians(deg), size=3)
    return lie.so3_exp(torch.as_tensor(w, dtype=dtype)).numpy()


def noisy_edges(V, window, noise_deg, seed, dtype):
    """The probe's graph on ``V`` ring views: (rs, R_gt, c_gt, edges,
    edge_R, edge_t), a window of ``window`` neighbours plus the ring's
    closure, each edge's relative rotation and unit direction perturbed by
    ``noise_deg`` and 3x ``noise_deg`` degrees. ``rs`` is left where the
    probe leaves it (``--full`` draws the pixel noise from it)."""
    rs = np.random.RandomState(seed)
    R_gt, c_gt = ring_poses(V)
    edges = [(i, j) for i in range(V)
             for j in range(i + 1, min(i + 1 + window, V))]
    edges += [(V - 1 - k, (V - 1 - k + window) % V) for k in range(window)]
    edges = sorted(set((min(a, b), max(a, b)) for a, b in edges))
    edge_R, edge_t = [], []
    for (a, b) in edges:
        R_rel = R_gt[b] @ R_gt[a].T @ rot_noise(rs, noise_deg, dtype)
        t_rel = -R_gt[b] @ (c_gt[b] - c_gt[a])
        t_rel = t_rel / np.linalg.norm(t_rel)
        t_rel = rot_noise(rs, 3 * noise_deg, dtype) @ t_rel
        edge_R.append(R_rel)
        edge_t.append(t_rel)
    return rs, R_gt, c_gt, edges, edge_R, edge_t


def stages(V, edges, edge_R, edge_t, R_gt, c_gt, dev, dtype) -> dict:
    """Rotation averaging, translation averaging and the pose-graph polish
    of the port on the edges, with each stage's error against the ground
    truth: ``rot_err`` (degrees per view), ``ate_ta``, ``ate_pg``, and the
    polished ``R_pg``, ``c_pg``."""
    import torch

    from sara_tpu_torch.core import lie
    from sara_tpu_torch.sfm.global_sfm import _translation_averaging_jit
    from sara_tpu_torch.sfm.pose_graph_opt import (PoseGraphProblem,
                                                   optimize_pose_graph)
    from sara_tpu_torch.sfm.rotation_averaging import average_rotations
    from sara_tpu_torch.utils import ate_rmse

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)

    ei = put([e[0] for e in edges], torch.int64)
    ej = put([e[1] for e in edges], torch.int64)
    R_abs = average_rotations(V, ei, ej, put(np.stack(edge_R))) \
        .cpu().double().numpy()
    M = sum(R_abs[v].T @ R_gt[v] for v in range(V))
    U, _, Vt = np.linalg.svd(M)
    S = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    rot_err = [np.degrees(np.arccos(np.clip(
        (np.trace(R_gt[v].T @ R_abs[v] @ S) - 1) / 2, -1, 1)))
        for v in range(V)]

    u_dirs = np.stack([-(R_abs[e[1]].T @ t) for e, t in zip(edges, edge_t)])
    centers = _translation_averaging_jit(ei, ej, put(u_dirs), V, 50) \
        .cpu().double().numpy()
    ate_ta = ate_rmse(centers, c_gt)

    t_abs = np.stack([-R_abs[v] @ centers[v] for v in range(V)])
    E_n = len(edges)
    poses6 = np.zeros((V, 6))
    poses6[:, :3] = lie.so3_log(put(R_abs)).cpu().double().numpy()
    poses6[:, 3:] = t_abs
    rel = np.zeros((E_n, 6))
    ok_e = np.zeros(E_n, bool)
    rel_w = lie.so3_log(put(np.stack(edge_R))).cpu().double().numpy()
    for k, ((a, b), tu) in enumerate(zip(edges, edge_t)):
        s_e = float(np.linalg.norm(centers[b] - centers[a]))
        if s_e < 1e-9:
            continue
        rel[k, :3] = rel_w[k]
        rel[k, 3:] = s_e * tu
        ok_e[k] = True
    prob = PoseGraphProblem(
        poses=put(poses6), edge_i=ei, edge_j=ej, rel_pose=put(rel),
        weight=put(np.ones(E_n)), edge_mask=put(ok_e, torch.bool),
        pose_fixed=put([True] + [False] * (V - 1), torch.bool))
    out, _ = optimize_pose_graph(prob, max_iters=15)
    p6 = out.poses.cpu().double().numpy()
    R_pg = lie.so3_exp(torch.as_tensor(p6[:, :3], dtype=dtype)).double() \
        .numpy()
    c_pg = np.stack([-R_pg[v].T @ p6[v, 3:] for v in range(V)])
    return {"rot_err": np.asarray(rot_err), "ate_ta": ate_ta,
            "ate_pg": ate_rmse(c_pg, c_gt), "R_pg": R_pg, "c_pg": c_pg}


def full(V, rs, R_gt, c_gt, R_init, c_init, args, dev, dtype) -> dict:
    """Triangulation of the synthetic tracks (900 points, 0.3 px noise from
    ``rs``) from the polished poses, then ``args.ba_rounds`` rounds of
    ``bundle_adjust``: the probe's stages 5-6, printed as it prints
    them."""
    import torch

    from sara_tpu_torch.ba import BAOptions, BAProblem, bundle_adjust
    from sara_tpu_torch.core import lie
    from sara_tpu_torch.sfm.global_sfm import _multiview_triangulate
    from sara_tpu_torch.utils import ate_rmse

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt).to(dev)

    n_pts = 900
    X_gt = np.random.RandomState(1).uniform(-5, 5, (n_pts, 3))
    K = np.array([[800.0, 0, 512.0], [0, 800.0, 384.0], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    obs_noise = 0.3
    uv_all = np.zeros((V, n_pts, 2))
    vis = np.zeros((V, n_pts), bool)
    for v in range(V):
        t_gt_v = -R_gt[v] @ c_gt[v]
        Xc = X_gt @ R_gt[v].T + t_gt_v
        ok = Xc[:, 2] > 1.0
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        ok &= ((uv[:, 0] >= 0) & (uv[:, 0] < 1024)
               & (uv[:, 1] >= 0) & (uv[:, 1] < 768))
        uv_all[v] = uv + rs.normal(scale=obs_noise, size=(n_pts, 2))
        vis[v] = ok

    track_pts = np.nonzero(vis.sum(axis=0) >= 2)[0]
    t_init = np.stack([-R_init[v] @ c_init[v] for v in range(V)])
    P_all = np.concatenate([R_init, t_init[:, :, None]], axis=2)
    max_len = int(vis[:, track_pts].sum(axis=0).max())
    Tn = len(track_pts)
    P_pad = np.zeros((Tn, max_len, 3, 4))
    uv_pad = np.zeros((Tn, max_len, 2))
    m_pad = np.zeros((Tn, max_len), bool)
    for ti, p in enumerate(track_pts):
        for k, v in enumerate(np.nonzero(vis[:, p])[0]):
            P_pad[ti, k] = P_all[v]
            xyn = Kinv @ np.array([uv_all[v, p, 0], uv_all[v, p, 1], 1.0])
            uv_pad[ti, k] = xyn[:2] / xyn[2]
            m_pad[ti, k] = True
    X_tri = _multiview_triangulate(put(P_pad), put(uv_pad),
                                   put(m_pad, torch.bool)).cpu().double() \
        .numpy()
    good = np.isfinite(X_tri).all(axis=1) & (
        np.linalg.norm(X_tri, axis=1) < 1e3)
    s_al, R_al, t_al = _umeyama(c_init, c_gt)
    X_al = s_al * (X_tri @ R_al) + t_al
    tri_err = np.linalg.norm(X_al[good] - X_gt[track_pts][good], axis=1)
    print(f"      triangulation: {good.sum()}/{Tn} good, "
          f"median err {np.median(tri_err):.4f}", flush=True)
    out = {"tri_good": int(good.sum()), "tracks": Tn,
           "tri_err_med": float(np.median(tri_err)), "ba": []}

    obs_cam, obs_pt, obs_uv = [], [], []
    kept = {}
    for ti, p in enumerate(track_pts):
        if not good[ti]:
            continue
        kept[ti] = len(kept)
        for v in np.nonzero(vis[:, p])[0]:
            obs_cam.append(v)
            obs_pt.append(kept[ti])
            obs_uv.append(uv_all[v, p])
    poses6 = np.zeros((V, 6))
    poses6[:, :3] = lie.so3_log(put(R_init)).cpu().double().numpy()
    poses6[:, 3:] = t_init
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    X_ba = X_tri[good][:len(kept)]
    for ba_round in range(args.ba_rounds):
        prob_ba = BAProblem(
            poses=put(poses6), points=put(X_ba), intrinsics=put(intr),
            cam_idx=put(obs_cam, torch.int64), pt_idx=put(obs_pt, torch.int64),
            uv=put(np.asarray(obs_uv)),
            obs_mask=torch.ones(len(obs_cam), dtype=torch.bool, device=dev),
            pose_fixed=put([True] + [False] * (V - 1), torch.bool),
            point_fixed=torch.zeros(len(kept), dtype=torch.bool, device=dev))
        out_ba, info = bundle_adjust(prob_ba,
                                     BAOptions(max_iters=args.ba_iters))
        poses6 = out_ba.poses.cpu().double().numpy()
        X_ba = out_ba.points.cpu().double().numpy()
        R_ba = lie.so3_exp(torch.as_tensor(poses6[:, :3], dtype=dtype)) \
            .double().numpy()
        c_ba = np.stack([-R_ba[v].T @ poses6[v, 3:] for v in range(V)])
        ate = ate_rmse(c_ba, c_gt)
        c0, c1 = (float(info[k]) for k in ("initial_cost", "final_cost"))
        print(f"      BA round {ba_round}: ATE {ate:.5f} "
              f"(cost {c0:.1f} -> {c1:.1f})", flush=True)
        out["ba"].append({"ate": ate, "initial_cost": c0, "final_cost": c1})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, nargs="+", default=[128, 256, 512])
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--noise-deg", type=float, default=0.3,
                    help="rotation noise per edge (deg); baseline-direction "
                         "noise uses 3x this")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="continue through triangulation + BA")
    ap.add_argument("--ba-rounds", type=int, default=1)
    ap.add_argument("--ba-iters", type=int, default=40)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    print("device:", dev, "dtype:", args.dtype, flush=True)
    results = {}
    for V in args.views:
        rs, R_gt, c_gt, edges, edge_R, edge_t = noisy_edges(
            V, args.window, args.noise_deg, args.seed, dtype)
        st = stages(V, edges, edge_R, edge_t, R_gt, c_gt, dev, dtype)
        rot_err = st["rot_err"]
        print(f"V={V:4d} edges={len(edges):5d} "
              f"rot_err mean={np.mean(rot_err):.4f} "
              f"max={np.max(rot_err):.4f} deg | "
              f"ATE ta={st['ate_ta']:.4f} pg={st['ate_pg']:.4f}", flush=True)
        results[V] = {"edges": len(edges),
                      "rot_err_mean": float(np.mean(rot_err)),
                      "rot_err_max": float(np.max(rot_err)),
                      "ate_ta": float(st["ate_ta"]),
                      "ate_pg": float(st["ate_pg"])}
        if args.full:
            results[V]["full"] = full(V, rs, R_gt, c_gt, st["R_pg"],
                                      st["c_pg"], args, dev, dtype)
    return results


if __name__ == "__main__":
    main()
