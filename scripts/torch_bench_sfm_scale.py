#!/usr/bin/env python
"""Unordered-SfM scale benchmark (BASELINE config 4 scaffolding) on the
PyTorch / CUDA port.

Twin of ``scripts/bench_sfm_scale.py``: a synthetic V-view collection
(cameras on a ring around a point cloud, capacity-N keypoints with planted
descriptors) through the whole global SfM (batched pair matching +
E-RANSAC in chunks of pairs, rotation and translation averaging,
multiview triangulation, Schur-complement BA). Reports per-stage wall
clock, pair throughput and ATE against the ground truth: the stages on
stderr, one JSON line on stdout.

It imports only ``sara_tpu_torch``, numpy and scipy, and runs on the card
unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_bench_sfm_scale.py [--views 128] [--chunk 32]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_ring_scene(n_views: int, n_points: int, capacity: int,
                    noise: float = 0.3, seed: int = 1, device="cuda"):
    """Cameras on a ring of radius 18 looking at a central point cloud, as
    the tool builds it (every view sees the cloud; each view keeps its
    first ``capacity`` visible point ids, so adjacent views share most of
    their points): (port ``Keypoints`` per view on ``device``, true
    centres, K)."""
    from sara_tpu_torch.convert import keypoints_from_numpy

    rs = np.random.RandomState(seed)
    X = rs.uniform(-5, 5, (n_points, 3))
    desc = rs.normal(size=(n_points, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[800.0, 0, 512.0], [0, 800.0, 384.0], [0, 0, 1.0]])

    kps, centers = [], []
    for f in range(n_views):
        ang = 2 * np.pi * f / n_views
        c = np.array([18.0 * np.cos(ang), 2.0 * np.sin(3 * ang),
                      18.0 * np.sin(ang)])
        # Look at the origin: z-axis toward -c.
        z = -c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0])
        xax = np.cross(up, z)
        xax /= np.linalg.norm(xax)
        yax = np.cross(z, xax)
        R = np.stack([xax, yax, z])         # world -> camera rows
        t = -R @ c
        centers.append(c)
        Xc = X @ R.T + t
        vis = Xc[:, 2] > 1.0
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        inside = ((uv[:, 0] >= 0) & (uv[:, 0] < 1024)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < 768))
        idx = np.nonzero(vis & inside)[0][:capacity]
        n = len(idx)
        xy = np.zeros((capacity, 2), np.float32)
        xy[:n] = uv[idx] + rs.normal(scale=noise, size=(n, 2))
        d = np.zeros((capacity, 128), np.float32)
        d[:n] = desc[idx]
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        kps.append(keypoints_from_numpy(
            (xy, np.full(capacity, 2.0, np.float32),
             np.zeros(capacity, np.float32), mask.astype(np.float32), d,
             mask), device))
    return kps, np.asarray(centers), K


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=128)
    ap.add_argument("--points", type=int, default=900,
                    help="cloud size; ~half is visible per ring view, so "
                         "keep below 2x capacity for dense overlap")
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--window", type=int, default=4,
                    help="pair each view with the next k views")
    ap.add_argument("--chunk", type=int, default=32,
                    help="pairs per batched program")
    ap.add_argument("--samples", type=int, default=256,
                    help="RANSAC hypotheses per pair")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ba-iters", type=int, default=40)
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse

    dev = resolve_device(args.device)
    log(f"building synthetic collection: {args.views} views, "
        f"{args.points} points, capacity {args.capacity}")
    kps, centers_gt, K = make_ring_scene(
        n_views=args.views, n_points=args.points, capacity=args.capacity,
        device=dev)

    pairs = [(i, j) for i in range(args.views)
             for j in range(i + 1, min(i + 1 + args.window, args.views))]
    log(f"{len(pairs)} pairs, chunk {args.chunk} "
        f"-> {-(-len(pairs) // args.chunk)} batched programs")

    cfg = GlobalSfMConfig(rel_pose_samples=args.samples,
                          min_pair_inliers=20, pair_chunk=args.chunk,
                          ba_options=BAOptions(max_iters=args.ba_iters))

    t0 = time.perf_counter()
    out = run_global_sfm(kps, K, pairs=pairs, config=cfg, device=dev)
    total = time.perf_counter() - t0

    R, t = np.asarray(out["R"]), np.asarray(out["t"])
    centers = np.stack([-R[v].T @ t[v] for v in range(args.views)])
    err = ate_rmse(centers, centers_gt)
    pair_rate = len(pairs) / total

    log(f"total {total:.1f}s ({pair_rate:.1f} pairs/s incl. averaging/BA), "
        f"edges {out['num_edges']}, points {len(out['points'])}, "
        f"ATE {err:.4f}")
    for k, v in out.get("stage_times", {}).items():
        log(f"  stage {k}: {v:.2f}s")
    result = {
        "metric": "global_sfm_views_per_s",
        "value": round(args.views / total, 3),
        "unit": "views/s",
        "views": args.views,
        "pairs": len(pairs),
        "ate": round(float(err), 4),
        "total_s": round(total, 1),
    }
    print(json.dumps(result))
    return dict(result, edges=[tuple(int(i) for i in e)
                               for e in out["edges"]],
                num_edges=int(out["num_edges"]),
                points=int(len(out["points"])),
                stage_times={k: float(v) for k, v in
                             out.get("stage_times", {}).items()},
                ba_info={k: float(out["ba_info"][k])
                         for k in ("initial_cost", "final_cost")})


if __name__ == "__main__":
    main()
