"""Steady-state VO frontend cost on the PyTorch / CUDA port, per-frame
against windowed dispatch.

Twin of ``scripts/bench_vo_frontend.py``: renders a short 3-D-room sequence
(``tests/render3d.py::make_room(seed=1)``) and runs
``OdometryPipeline.process_frames`` (``frontend_batch`` frames of undistort
+ detect + match + E-RANSAC per window) against the per-frame path, host
integration (tracker, PnP, BA) included. The descriptors take the kernel
sampler (``ops/patch_sampler.py``'s CUDA kernel on the card, its plain
version on the CPU).

It imports only ``sara_tpu_torch``, numpy, scipy and the numpy helpers of
``tests/``, and runs on the card unless ``--device cpu`` is given; without
a card it raises.

Usage: python scripts/torch_bench_vo_frontend.py [--frames 12] [--batch 4]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np


def make_frames(n):
    from render3d import make_room, render

    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    planes = make_room(seed=1)
    imgs, centers = [], []
    for i in range(n):
        ang = 0.02 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([0.2 * i, 0.0, 0.25 * i])
        imgs.append(np.asarray(render(planes, K, R, -R @ c), np.float32))
        centers.append(c)
    return imgs, np.asarray(centers), K


def run(pipe, imgs, batched, sync):
    t0 = time.perf_counter()
    if batched:
        ok = [bool(o) for o in pipe.process_frames(imgs,
                                                   list(range(len(imgs))))]
    else:
        ok = [bool(pipe.process_frame(im, f)) for f, im in enumerate(imgs)]
    sync()
    return ok, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-per-frame", action="store_true")
    ap.add_argument("--ba-every", type=int, default=1,
                    help="BA cadence; a large value isolates the frontend "
                    "(per-frame BA dominates the loop otherwise)")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.utils import ate_rmse

    dev = resolve_device(args.device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    imgs, centers, K = make_frames(args.frames)

    def cfg(b):
        c = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                           rel_pose_min_inliers=40, pnp_min_inliers=15,
                           ba_window=6, frontend_batch=b,
                           ba_every=args.ba_every)
        return dataclasses.replace(c, sift=dataclasses.replace(
            c.sift, desc_sampler="kernel"))

    results = {}
    for label, batched in ([("batched", True)] if args.skip_per_frame
                           else [("batched", True), ("per-frame", False)]):
        # A warm pass over the whole sequence first: the BA and PnP shape
        # buckets grow with the graph.
        run(OdometryPipeline(K, cfg(args.batch), device=dev), imgs, batched,
            sync)
        pipe = OdometryPipeline(K, cfg(args.batch), device=dev)
        ok, dt = run(pipe, imgs, batched, sync)
        acc = sum(ok)
        err = ate_rmse(pipe.pose_graph.trajectory(),
                       centers[np.flatnonzero(ok)])
        print(f"{label:10s}: {acc}/{args.frames} accepted, "
              f"{dt / max(acc, 1) * 1e3:.0f} ms/frame, ATE {err:.4f}")
        results[label] = {"accepted": acc, "ms_per_frame":
                          dt / max(acc, 1) * 1e3, "ate": float(err)}
    return results


if __name__ == "__main__":
    main()
