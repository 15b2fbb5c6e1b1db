"""VO evaluation harness (BASELINE configs 2/3) on the PyTorch / CUDA port.

Twin of ``scripts/eval_vo.py``: the odometry pipeline on a synthetic
N-frame keypoint sequence (optionally a closed loop with loop closure), or
with ``--room`` BASELINE config 3: a loop trajectory rendered inside the
textured room (``torch_eval_real_images.make_real_room``: the reference's
photographs, or ``make_room(seed=1)``'s procedural textures where they are
missing), pixels -> trajectory VO with the BA cadence on, loop closure and
a JSON artifact with accepted frames / fps / ATE before and after closure.
The room's descriptors take the kernel sampler (``ops/patch_sampler.py``'s
CUDA kernel on the card, its plain version on the CPU).

It imports only ``sara_tpu_torch``, numpy, scipy and the numpy helpers of
``tests/``, and runs on the card unless ``--device cpu`` is given; without
a card it raises.

Usage: python scripts/torch_eval_vo.py [--frames 60] [--loop] [--device cpu]
       python scripts/torch_eval_vo.py --room --frames 100 --loop
           [--device cpu] [--out torch_eval_vo_room.json]
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


def _frame_fields(X, desc, K, R, c, capacity, noise, rs):
    """One frame's keypoint fields (xy, scale, orientation, response,
    descriptors, mask) of the points of X the camera (R, c) sees."""
    t = -R @ c
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
    return (xy, np.full(capacity, 2.0, np.float32),
            np.zeros(capacity, np.float32), mask.astype(np.float32), d, mask)


def make_sequence(n_frames=10, n_points=300, noise=0.3, seed=0,
                  capacity=512):
    """Cameras orbiting a point cloud (``tests/test_sfm_pipeline.py::
    _make_sequence`` in numpy): (frames' keypoint fields, centres, K)."""
    from geometry_fixtures import default_K

    rs = np.random.RandomState(seed)
    X = rs.uniform(-4, 4, (n_points, 3)) + np.array([0, 0, 12.0])
    X[:, 2] = rs.uniform(8.0, 12.0 + 0.5 * n_frames, n_points)
    desc = rs.normal(size=(n_points, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = default_K()
    frames, centers = [], []
    for f in range(n_frames):
        ang = 0.35 * np.sin(0.1 * f)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([2.0 * np.sin(0.1 * f), 0.1 * f, 0.5 * f])
        centers.append(c)
        frames.append(_frame_fields(X, desc, K, R, c, capacity, noise, rs))
    return frames, np.asarray(centers), K


def make_loop_sequence(n_frames=24, n_points=600, noise=0.25, seed=0,
                       capacity=512, radius=6.0):
    """A camera orbiting the scene centre on a closed circle, points on a
    surrounding cylinder (``tests/test_loop_closure.py::
    _make_loop_sequence`` in numpy): (frames' fields, centres, K)."""
    from geometry_fixtures import default_K

    rs = np.random.RandomState(seed)
    ang_p = rs.uniform(0, 2 * np.pi, n_points)
    rad_p = rs.uniform(radius + 4.0, radius + 12.0, n_points)
    X = np.stack([rad_p * np.sin(ang_p), rs.uniform(-3, 3, n_points),
                  rad_p * np.cos(ang_p)], axis=1)
    desc = rs.normal(size=(n_points, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = default_K()
    frames, centers = [], []
    for f in range(n_frames):
        ang = 2 * np.pi * f / n_frames
        c = radius * np.array([np.sin(ang), 0.0, np.cos(ang)])
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]]).T
        centers.append(c)
        frames.append(_frame_fields(X, desc, K, R, c, capacity, noise, rs))
    return frames, np.asarray(centers), K


def room_loop(n_frames, hw, r_loop=1.6):
    """The circular loop inside the room (it returns to its start):
    (K, images, centres)."""
    from render3d import render
    from torch_eval_real_images import make_real_room

    K = np.array([[0.94 * hw[1], 0, hw[1] / 2],
                  [0, 0.94 * hw[1], hw[0] / 2], [0, 0, 1.0]])
    planes = make_real_room()
    imgs, centers = [], []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        c = np.array([0.5 + r_loop * np.sin(a), 0.0,
                      4.0 + r_loop * (1 - np.cos(a))])
        yaw = 0.25 * np.sin(a)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        with np.errstate(invalid="ignore", divide="ignore"):
            imgs.append(np.asarray(render(planes, K, R, -R @ c, hw=hw),
                                   np.float32))
        centers.append(c)
    return K, imgs, np.asarray(centers)


def run_room(args, dev):
    """Config-3 run: the textured room, circular loop. Returns the
    artifact."""
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.sfm.loop_closure import LoopCloser, LoopClosureConfig
    from sara_tpu_torch.utils import ate_rmse
    from torch_eval_real_images import room_scene

    hw = (args.height, args.width)
    K, imgs, centers = room_loop(args.frames, hw)
    cfg = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=8, full_ba_every=args.full_ba_every,
                         ba_every=args.ba_every,
                         frontend_batch=args.frontend_batch)
    cfg = dataclasses.replace(cfg, sift=dataclasses.replace(
        cfg.sift, desc_sampler="kernel"))
    pipe = OdometryPipeline(K, cfg, device=dev)
    closer = (LoopCloser(K, LoopClosureConfig(
        min_gap=max(args.frames // 4, 15), min_inliers=40,
        rel_pose_samples=300, post_ba=args.post_ba), device=dev)
        if args.loop else None)

    t0 = time.perf_counter()
    ok = []
    frame_ms = []
    if args.pipelined:
        # process_frames dispatches window k+1 while the host integrates
        # window k; loop closure rides the on_accept hook.
        if closer is not None:
            pipe.on_accept = lambda kp, vid: closer.add_frame(kp)
        warm = min(12, len(imgs) // 4)
        ok += [bool(v) for v in pipe.process_frames(imgs[:warm],
                                                    list(range(warm)))]
        t0 = time.perf_counter()
        ok += [bool(v) for v in pipe.process_frames(
            imgs[warm:], list(range(warm, len(imgs))))]
        elapsed = time.perf_counter() - t0
        steady = elapsed / max(len(imgs) - warm, 1) * 1e3
        print(f"pipelined steady: {steady:.0f} ms/frame over "
              f"{len(imgs) - warm} frames", file=sys.stderr, flush=True)
    else:
        for f, im in enumerate(imgs):
            tf = time.perf_counter()
            accepted = bool(pipe.process_frame(im, f))
            frame_ms.append((time.perf_counter() - tf) * 1e3)
            ok.append(accepted)
            if accepted and closer is not None:
                closer.add_frame(pipe._prev_keypoints)
            print(f"frame {f}: {'ok' if accepted else 'REJECTED'} "
                  f"({pipe.point_cloud.num_points} pts, "
                  f"{frame_ms[-1]:.0f} ms)", file=sys.stderr, flush=True)
        elapsed = time.perf_counter() - t0
        # Steady state leaves out the first frames.
        steady = (np.median(frame_ms[10:]) if len(frame_ms) > 20
                  else float("nan"))
    accepted = sum(ok)
    gt_sel = centers[np.flatnonzero(ok)]
    ate_before = float(ate_rmse(pipe.pose_graph.trajectory(), gt_sel))

    closed = False
    ate_after = ate_before
    if closer is not None:
        closed = bool(closer.close(pipe, accepted - 1))
        ate_after = float(ate_rmse(pipe.pose_graph.trajectory(), gt_sel))

    artifact = {
        "config": "baseline-3-room-loop",
        "scene": room_scene(),
        "pipelined": bool(args.pipelined),
        "full_ba_every": args.full_ba_every,
        "backend": dev.type,
        "frames": args.frames,
        "resolution": list(hw),
        "accepted": accepted,
        "fps": round(accepted / elapsed, 3),
        "ms_per_frame": round(elapsed / max(accepted, 1) * 1e3, 1),
        "steady_ms_per_frame": round(float(steady), 1),
        "steady_fps": round(1e3 / float(steady), 2) if steady == steady
        else None,
        "ate_before_closure": round(ate_before, 5),
        "loop_closed": closed,
        "ate_after_closure": round(ate_after, 5),
        "map_points": int(pipe.point_cloud.num_points),
    }
    print(json.dumps(artifact))
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
                if not isinstance(existing, list):
                    existing = [existing]
        existing.append(artifact)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
        print(f"artifact appended to {args.out}", file=sys.stderr)
    return artifact


def run_keypoints(args, dev):
    """Configs 2/3 at keypoint level: the synthetic sequence (or loop)
    through ``process_keypoints``. Returns what it printed, as a dict."""
    from sara_tpu_torch.convert import keypoints_from_numpy
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.sfm.loop_closure import LoopCloser, LoopClosureConfig
    from sara_tpu_torch.utils import ate_rmse

    if args.loop:
        frames, centers_gt, K = make_loop_sequence(n_frames=args.frames,
                                                   noise=args.noise)
    else:
        frames, centers_gt, K = make_sequence(
            n_frames=args.frames, n_points=800, noise=args.noise)

    cfg = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                         rel_pose_min_inliers=40, pnp_min_inliers=20,
                         ba_window=8)
    pipe = OdometryPipeline(K, cfg, device=dev)
    closer = (LoopCloser(K, LoopClosureConfig(
        min_gap=15, min_inliers=40, rel_pose_samples=300), device=dev)
        if args.loop else None)

    t0 = time.perf_counter()
    ok = []
    for f, fields in enumerate(frames):
        kp = keypoints_from_numpy(fields, dev)
        ok.append(bool(pipe.process_keypoints(kp, f)))
        if ok[-1] and closer is not None:
            closer.add_frame(kp)
    elapsed = time.perf_counter() - t0
    accepted = sum(ok)
    gt_sel = centers_gt[np.flatnonzero(ok)]
    err = ate_rmse(pipe.pose_graph.trajectory(), gt_sel)
    print(f"frames accepted: {accepted}/{args.frames}")
    print(f"throughput: {accepted/elapsed:.2f} frames/s "
          f"({elapsed/max(accepted,1)*1e3:.0f} ms/frame incl. host)")
    print(f"ATE-RMSE before loop closure: {err:.4f}")
    print(f"map points: {pipe.point_cloud.num_points}")
    out = {"frames": args.frames, "accepted": accepted,
           "ate_before": float(err), "fps": accepted / elapsed,
           "map_points": int(pipe.point_cloud.num_points)}
    if closer is not None:
        closed = closer.close(pipe, accepted - 1)
        err2 = ate_rmse(pipe.pose_graph.trajectory(), gt_sel)
        print(f"loop closed: {closed}; ATE after: {err2:.4f}")
        out.update(loop_closed=bool(closed), ate_after=float(err2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--pipelined", action="store_true",
                    help="drive the pipelined process_frames loop")
    ap.add_argument("--room", action="store_true",
                    help="render the textured room loop (config 3)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--full-ba-every", type=int, default=8,
                    help="periodic full-trajectory BA cadence (0 = off)")
    ap.add_argument("--ba-every", type=int, default=1,
                    help="windowed-BA cadence (accepted frames per BA)")
    ap.add_argument("--frontend-batch", type=int, default=4,
                    help="frames per frontend window (pipelined)")
    ap.add_argument("--post-ba", action="store_true",
                    help="enable the post-closure full-trajectory BA")
    ap.add_argument("--out", default="torch_eval_vo_room.json")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    if args.room:
        return run_room(args, dev)
    return run_keypoints(args, dev)


if __name__ == "__main__":
    main()
