"""Real-pixel multi-view evaluation on the PyTorch / CUDA port.

Twin of ``scripts/eval_real_images.py``: a 3-D room whose floor and walls
carry the reference's photographs (its data directory,
``io/datasets.REFERENCE_DATA``), rendered from
known poses, through the pixels -> trajectory VO pipeline and the
unordered global SfM. Where the photographs are missing, the room takes
``tests/render3d.py::make_room(seed=1)``'s procedural textures, as
``chip_smoke.py``'s phase "loop" does. It imports only ``sara_tpu_torch``,
numpy, scipy and the numpy helpers of ``tests/``, and runs on the card
unless ``--device cpu`` is given; without a card it raises. The
descriptors take the kernel sampler (``ops/patch_sampler.py``'s CUDA
kernel on the card, its plain version on the CPU).

Usage: python scripts/torch_eval_real_images.py [--device cpu] [--frames 10]
       [--out torch_eval_real_images.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "tests"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np

from sara_tpu_torch.io.datasets import REFERENCE_DATA as DATA

PHOTOS = ("sunflowerField.jpg", "dog.jpg", "GuardOnBlonde.tif")


def _load_tex(name, size=1024):
    import PIL.Image

    img = PIL.Image.open(os.path.join(DATA, name)).convert("L")
    img = img.resize((size, size))
    return np.asarray(img, np.float32) / 255.0


def have_photographs() -> bool:
    return all(os.path.exists(os.path.join(DATA, n)) for n in PHOTOS)


def make_real_room():
    """Floor + two walls textured with the reference's photographs; the
    procedural room of ``make_room(seed=1)`` where they are missing."""
    from render3d import TexturedPlane, make_room

    if not have_photographs():
        return make_room(seed=1)
    texs = [_load_tex(n) for n in PHOTOS]
    return [
        TexturedPlane([0, 1.2, 6], [1, 0, 0], [0, 0, 1], texs[0],
                      (-6, 6), (0, 14)),
        TexturedPlane([0, 0, 12], [1, 0, 0], [0, 1, 0], texs[1],
                      (-6, 6), (-3, 3)),
        TexturedPlane([-4, 0, 6], [0, 0, 1], [0, 1, 0], texs[2],
                      (0, 14), (-3, 3)),
    ]


def room_scene() -> str:
    return ("real-texture room (sunflowerField/dog/GuardOnBlonde)"
            if have_photographs()
            else "procedural-texture room (render3d.make_room(seed=1))")


def pose_similarity_alignment(R_est, c_est, R_gt, c_gt):
    """Similarity x_gt = s Q x_est + t using ORIENTATIONS as well as
    centers (the tool's alignment): Q is the chordal mean of R_gt_v^T
    R_est_v; s, t follow by least squares."""
    M = np.zeros((3, 3))
    for Rg, Re in zip(R_gt, R_est):
        M += Rg.T @ Re
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    Q = U @ S @ Vt
    ce = np.asarray(c_est)
    cg = np.asarray(c_gt)
    ce_r = ce @ Q.T
    mu_e, mu_g = ce_r.mean(0), cg.mean(0)
    num = ((cg - mu_g) * (ce_r - mu_e)).sum()
    den = ((ce_r - mu_e) ** 2).sum()
    s = num / max(den, 1e-12)
    t = mu_g - s * mu_e
    return s, Q, t


def plane_stats(points, planes, tol=0.2):
    """Median distance of reconstructed points to the NEAREST scene plane
    + fraction within tol."""
    d = []
    for p in points:
        dists = []
        for pl in planes:
            n = np.cross(pl.u, pl.v)
            n = n / np.linalg.norm(n)
            dists.append(abs((p - pl.o) @ n))
        d.append(min(dists))
    if not d:
        return float("nan"), 0.0
    d = np.asarray(d)
    return float(np.median(d)), float((d < tol).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="torch_eval_real_images.json")
    args = ap.parse_args(argv)

    from render3d import render
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse

    dev = resolve_device(args.device)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    planes = make_real_room()

    imgs, centers, Rgts = [], [], []
    for i in range(args.frames):
        ang = 0.02 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([0.22 * i, 0.0, 0.28 * i])
        imgs.append(np.asarray(render(planes, K, R, -R @ c, hw=(480, 640)),
                               np.float32))
        centers.append(c)
        Rgts.append(R)
    centers = np.asarray(centers)

    # --- VO from the rendered pixels. ---
    cfg = OdometryConfig(rel_pose_samples=400, pnp_samples=400,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=6)
    cfg = dataclasses.replace(cfg, sift=dataclasses.replace(
        cfg.sift, desc_sampler="kernel"))
    pipe = OdometryPipeline(K, cfg, device=dev)
    t0 = time.perf_counter()
    ok = [bool(pipe.process_frame(im, f)) for f, im in enumerate(imgs)]
    vo_s = time.perf_counter() - t0
    traj = pipe.pose_graph.trajectory()
    gt_sel = centers[np.flatnonzero(ok)]
    vo_ate = float(ate_rmse(traj, gt_sel))
    # Monocular gauge: align the points with the similarity that aligns
    # the trajectory.
    sel = np.flatnonzero(ok)
    R_est_vo = [pipe.pose_graph.pose(v)[0] for v in range(len(traj))]
    R_gt_vo = [Rgts[i] for i in sel]
    s_al, Q_al, t_al = pose_similarity_alignment(R_est_vo, traj,
                                                 R_gt_vo, gt_sel)
    pts_al = (s_al * (Q_al @ pipe.point_cloud.points.T)).T + t_al
    vo_med, vo_frac = plane_stats(pts_al, planes)

    # --- Global SfM on the same views. ---
    kps = [compute_sift_keypoints(im, cfg.sift, device=dev) for im in imgs]
    gcfg = GlobalSfMConfig(rel_pose_samples=400, min_pair_inliers=25,
                           pair_chunk=8)
    t0 = time.perf_counter()
    out = run_global_sfm(kps, K, config=gcfg, device=dev)
    gs_s = time.perf_counter() - t0
    R_fin, t_fin = np.asarray(out["R"]), np.asarray(out["t"])
    est_centers = np.stack([-R_fin[v].T @ t_fin[v]
                            for v in range(args.frames)])
    gs_ate = float(ate_rmse(est_centers, centers))
    s_al, Q_al, t_al = pose_similarity_alignment(
        list(R_fin), est_centers, Rgts, centers)
    gpts_al = (s_al * (Q_al @ np.asarray(out["points"]).T)).T + t_al
    gs_med, gs_frac = plane_stats(gpts_al, planes)
    # The BA's final (trimmed Huber) cost, the tool's proxy for the
    # reprojection error.
    reproj = float(out["ba_info"]["final_cost"])

    result = {
        "scene": room_scene(),
        "frames": args.frames,
        "vo": {"accepted": int(sum(ok)), "ate": round(vo_ate, 4),
               "plane_median_dist": round(vo_med, 4),
               "plane_inlier_frac": round(vo_frac, 3),
               "points": int(pipe.point_cloud.num_points),
               "seconds": round(vo_s, 1)},
        "global_sfm": {"edges": int(out["num_edges"]),
                       "ate": round(gs_ate, 4),
                       "plane_median_dist": round(gs_med, 4),
                       "plane_inlier_frac": round(gs_frac, 3),
                       "points": int(len(out["points"])),
                       "ba_final_cost": round(reproj, 2),
                       "seconds": round(gs_s, 1)},
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    # What was printed, with the global SfM's BA problem as triangulation
    # handed it over and the true centres, for a float64 solve of the same
    # problem.
    return dict(result, ba_problem=out["ba_problem"], centers=centers)


if __name__ == "__main__":
    main()
