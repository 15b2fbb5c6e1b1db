"""Stage by stage, the city-scale global SfM's error (BASELINE config 5) on
the PyTorch / CUDA port.

Twin of ``scripts/probe_city_stages.py``. ``run_global_sfm`` runs on the
city scene of ``scripts/torch_bench_city_scale_scene.py`` (the probe's
``make_city_scene``, its proximity pairs and its ground-truth rotations,
the same numpy draws) with the probe's configuration (192 hypotheses, 20
inliers per pair, chunks of 32 pairs, BA 20 iterations), and each stage
is held to the ground truth:

- per edge, the relative rotation's and the baseline direction's error;
- the global rotations' error after the gauge alignment;
- the final ATE, and the ATE of the translation-averaged centres.

The error functions (``edge_errors``, ``global_rotation_errors``,
``centers_of``) take ``run_global_sfm``'s output as plain arrays, so the
reference's output can be fed to them too.

It imports only ``sara_tpu_torch``, numpy and
``scripts/torch_bench_city_scale_scene.py``, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_city_stages.py [views] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def edge_errors(edges, edge_R, edge_t, R_gt, centers_gt):
    """(rotation errors, direction errors) in degrees of each edge (a, b)
    of ``edges`` against the ground truth; a direction's sign is free.
    The arrays keep their dtypes, as the probe's arithmetic does."""
    rot_errs, dir_errs = [], []
    for idx, (a, b) in enumerate(edges):
        Rr = np.asarray(edge_R[idx])
        tr = np.asarray(edge_t[idx])
        Rr_gt = R_gt[b] @ R_gt[a].T
        e_rot = np.degrees(np.arccos(np.clip(
            (np.trace(Rr_gt.T @ Rr) - 1) / 2, -1, 1)))
        t_gt = R_gt[b] @ (centers_gt[a] - centers_gt[b])
        t_gt = t_gt / max(np.linalg.norm(t_gt), 1e-12)
        tn = tr / max(np.linalg.norm(tr), 1e-12)
        e_dir = np.degrees(np.arccos(np.clip(abs(float(tn @ t_gt)), -1, 1)))
        rot_errs.append(e_rot)
        dir_errs.append(e_dir)
    return np.array(rot_errs), np.array(dir_errs)


def global_rotation_errors(R_est, R_gt):
    """Each view's rotation error in degrees after the gauge G = argmin
    sum ||R_est G - R_gt|| (the polar factor of sum R_est^T R_gt)."""
    R_est = np.asarray(R_est)
    M = sum(R_est[v].T @ R_gt[v] for v in range(len(R_gt)))
    U, _, Vt = np.linalg.svd(M)
    G = U @ Vt
    return np.array([np.degrees(np.arccos(np.clip(
        (np.trace((R_est[v] @ G).T @ R_gt[v]) - 1) / 2, -1, 1)))
        for v in range(len(R_gt))])


def centers_of(R, t):
    """Camera centres -R^T t of world-to-camera poses (in their dtype)."""
    R, t = np.asarray(R), np.asarray(t)
    return np.stack([-R[v].T @ t[v] for v in range(len(R))])


def report(out: dict, R_gt, centers_gt, n_pairs: int) -> dict:
    """The probe's lines for one ``run_global_sfm`` output (arrays), and
    their numbers."""
    from sara_tpu_torch.utils import ate_rmse

    views = len(R_gt)
    rot_errs, dir_errs = edge_errors(out["edges"], out["edge_R"],
                                     out["edge_t"], R_gt, centers_gt)
    res = {"edges": len(rot_errs), "pairs": n_pairs,
           "edge_rot_med": float(np.median(rot_errs)),
           "edge_rot_p90": float(np.percentile(rot_errs, 90)),
           "edge_dir_med": float(np.median(dir_errs)),
           "edge_dir_p90": float(np.percentile(dir_errs, 90))}
    print(f"edges {len(rot_errs)}/{n_pairs}: "
          f"rot err med {res['edge_rot_med']:.3f} deg "
          f"p90 {res['edge_rot_p90']:.2f}, "
          f"dir err med {res['edge_dir_med']:.2f} deg "
          f"p90 {res['edge_dir_p90']:.2f}", flush=True)
    rot_glob = global_rotation_errors(out["R"], R_gt)
    res.update(global_rot_med=float(np.median(rot_glob)),
               global_rot_max=float(np.max(rot_glob)))
    print(f"global rotations: med {res['global_rot_med']:.3f} deg "
          f"max {res['global_rot_max']:.2f}", flush=True)
    res["final_ate"] = float(ate_rmse(centers_of(out["R"], out["t"]),
                                      centers_gt))
    print(f"final ATE {res['final_ate']:.4f}", flush=True)
    if "centers_averaged" in out:
        res["post_averaging_ate"] = float(ate_rmse(
            np.asarray(out["centers_averaged"]), centers_gt))
        print(f"post-averaging ATE {res['post_averaging_ate']:.4f}",
              flush=True)
    assert views == len(out["R"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("views", nargs="?", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from torch_bench_city_scale_scene import (gt_rotations, make_city_scene,
                                              proximity_pairs)

    dev = resolve_device(args.device)
    views = args.views
    kps, centers_gt, K = make_city_scene(views, device=dev)
    pairs = proximity_pairs(centers_gt)
    print(f"{views} views, {len(pairs)} pairs", flush=True)
    R_gt = gt_rotations(views)
    cfg = GlobalSfMConfig(rel_pose_samples=192, min_pair_inliers=20,
                          pair_chunk=32, ba_options=BAOptions(max_iters=20))
    out = run_global_sfm(kps, K, pairs=pairs, config=cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    arrays = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
              for k, v in out.items()
              if k in ("edges", "edge_R", "edge_t", "R", "t",
                       "centers_averaged")}
    return report(arrays, R_gt, centers_gt, len(pairs))


if __name__ == "__main__":
    main()
