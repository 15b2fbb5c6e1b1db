"""Seeded A/B of per-frame against batched / pipelined VO on the room
loop, on the PyTorch / CUDA port.

Twin of ``scripts/probe_ab_vo.py``. Both modes run over SEVERAL seeds in
one process and print the ATE distribution: distributions that overlap
say RANSAC-draw variance, a systematic offset says a fault in the windows of
``process_frames``. "per_frame" calls ``process_frame`` frame by frame;
"batched" calls ``process_frames``, whose windows of ``frontend_batch``
frames go through the batched frontend (``sfm/odometry.py::
_fused_frontend_batch``). A seed reseeds the pipeline's one generator
(``1000 + seed``, where the probe sets its PRNG key).

The frames are the probe's renders of
``scripts/torch_eval_real_images.py::make_real_room`` (the reference's
photographs, or ``make_room(seed=1)`` without them). It imports only
``sara_tpu_torch``, numpy and the numpy helpers of ``tests/``, and runs on
the card unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_ab_vo.py [--device cpu] [--frames 40]
       [--seeds 3] [--seed0 0] [--modes per_frame,batched] [--width 320]
       [--height 240]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT, "scripts")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

MODES = ("per_frame", "batched", "batched_B1", "per_frame_full",
         "warm_then_batched", "batched_fullba", "per_frame_fullba")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--modes", default="per_frame,batched",
                    help="comma list of: " + ", ".join(MODES))
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.utils import ate_rmse
    from torch_probe_batch_parity import render_frames

    dev = resolve_device(args.device)
    mode_list = args.modes.split(",")
    unknown = sorted(set(mode_list) - set(MODES))
    if unknown:
        raise ValueError(f"unknown modes {unknown}")
    K, imgs, _, centers = render_frames(args.frames,
                                        (args.height, args.width))
    centers = np.asarray(centers)
    frames = imgs                 # host frames, as a camera hands them over

    cfg = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=8)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    results = {m: [] for m in mode_list}
    for seed in range(args.seed0, args.seed0 + args.seeds):
        for mode in mode_list:
            mcfg = cfg
            if mode == "batched_B1":
                mcfg = dataclasses.replace(cfg, frontend_batch=1)
            elif mode == "per_frame_full":
                mcfg = dataclasses.replace(cfg, rel_pose_samples_fast=0)
            elif mode in ("batched_fullba", "per_frame_fullba"):
                mcfg = dataclasses.replace(cfg, full_ba_every=8)
            pipe = OdometryPipeline(K, mcfg, device=dev)
            pipe._gen.manual_seed(1000 + seed)
            sync()
            t0 = time.perf_counter()
            if mode in ("per_frame", "per_frame_full", "per_frame_fullba"):
                ok = [bool(pipe.process_frame(frames[f], f))
                      for f in range(args.frames)]
            elif mode == "warm_then_batched":
                warm = 5
                ok = [bool(pipe.process_frame(frames[f], f))
                      for f in range(warm)]
                ok += [bool(v) for v in pipe.process_frames(
                    frames[warm:], list(range(warm, args.frames)))]
            else:
                ok = [bool(v) for v in pipe.process_frames(
                    frames, list(range(args.frames)))]
            sync()
            wall = time.perf_counter() - t0
            gt = centers[np.flatnonzero(ok)]
            ate = float(ate_rmse(pipe.pose_graph.trajectory(), gt))
            results[mode].append(
                dict(seed=seed, ate=round(ate, 4), accepted=sum(ok),
                     ms_per_frame=round(wall / args.frames * 1e3, 1)))
            print(json.dumps({"mode": mode, **results[mode][-1],
                              "backend": dev.type}), flush=True)

    summary = {}
    for mode, rows in results.items():
        ates = [r["ate"] for r in rows]
        summary[mode] = {"ate_min": min(ates),
                         "ate_med": sorted(ates)[len(ates) // 2],
                         "ate_max": max(ates)}
        print(json.dumps({"summary": mode, **summary[mode]}), flush=True)
    return {"runs": results, "summary": summary}


if __name__ == "__main__":
    main()
