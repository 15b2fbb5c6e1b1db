"""VO from an actual video file on the PyTorch / CUDA port.

Twin of ``scripts/eval_vo_video.py``:

1. render the room loop (``torch_eval_real_images.make_real_room``: the
   reference's photographs, or ``make_room(seed=1)``'s procedural textures
   where they are missing) THROUGH a Brown-Conrady distorted camera, by
   backprojecting the distorted pixels into rays;
2. encode it to an mp4 with ``sara_tpu_torch.io.video.VideoWriter``;
3. stream it back with ``VideoStream(num_skips=...)`` (lossy pixels, frame
   skipping) into ``OdometryPipeline`` with the Brown-Conrady undistortion
   maps, the live HTML viewer on and a ``LoopCloser``;
4. report the trajectory's ATE against the ground truth of the streamed
   frames, before and after loop closure.

The video goes through OpenCV (``io/video``); without ``cv2`` the twin
raises. It imports only ``sara_tpu_torch``, numpy, scipy and the numpy
helpers of ``tests/``, and runs on the card unless ``--device cpu`` is
given; without a card it raises.

Usage: python scripts/torch_eval_vo_video.py [--frames 100] [--skip 1]
       [--device cpu] [--out torch_eval_vo_video.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "tests"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np


def render_distorted_loop(planes, camera, n_frames, hw, r_loop=1.6):
    """Render the room loop through the distorted camera model."""
    import torch

    from render3d import render

    H, W = hw
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = torch.as_tensor(np.stack([xs, ys], axis=-1).reshape(-1, 2),
                         device=camera.k.device)
    rays = camera.backproject(uv).cpu().numpy()   # (H*W, 3), z = 1

    Kc = camera.K
    K = np.asarray(
        [[float(Kc.fx), float(Kc.s), float(Kc.u0)],
         [0.0, float(Kc.fy), float(Kc.v0)], [0, 0, 1.0]])
    imgs, centers, Rgts = [], [], []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        c = np.array([0.5 + r_loop * np.sin(a), 0.0,
                      4.0 + r_loop * (1 - np.cos(a))])
        yaw = 0.25 * np.sin(a)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        with np.errstate(invalid="ignore", divide="ignore"):
            imgs.append(render(planes, K, R, -R @ c, hw=hw, rays_cam=rays))
        centers.append(c)
        Rgts.append(R)
    return imgs, np.asarray(centers), Rgts


def write_video(path, imgs, fps=30.0):
    from sara_tpu_torch.io.video import VideoWriter

    h, w = imgs[0].shape
    vw = VideoWriter(path, (h, w), fps=fps)
    for im in imgs:
        u8 = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        vw.write(np.stack([u8] * 3, axis=-1))
    vw.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100,
                    help="frames rendered INTO the video")
    ap.add_argument("--skip", type=int, default=1,
                    help="VideoStream num_skips (reference VideoStreamer)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loop", action="store_true", default=True)
    ap.add_argument("--out", default="torch_eval_vo_video.json")
    ap.add_argument("--video", default="",
                    help="keep the mp4 here (default: temp file)")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.core.cameras import BrownConrady, undistortion_maps
    from sara_tpu_torch.io.video import VideoStream
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.sfm.loop_closure import LoopCloser, LoopClosureConfig
    from sara_tpu_torch.utils import ate_rmse
    from torch_eval_real_images import make_real_room, room_scene

    dev = resolve_device(args.device)
    hw = (args.height, args.width)
    f = 0.94 * hw[1]
    # Mild barrel + slight tangential distortion, a phone lens's
    # magnitudes.
    cam = BrownConrady.from_values(fx=f, fy=f, u0=hw[1] / 2.0,
                                   v0=hw[0] / 2.0, k=(-0.22, 0.05, 0.0),
                                   p=(1e-3, -5e-4), device=dev)

    print("rendering distorted room loop...", file=sys.stderr, flush=True)
    imgs, centers, _ = render_distorted_loop(
        make_real_room(), cam, args.frames, hw)

    video_path = args.video or os.path.join(
        tempfile.mkdtemp(prefix="sara_torch_vo_"), "room_loop.mp4")
    write_video(video_path, imgs)
    size_kb = os.path.getsize(video_path) / 1024
    print(f"wrote {video_path} ({size_kb:.0f} kB)", file=sys.stderr)

    K = np.array([[f, 0, hw[1] / 2], [0, f, hw[0] / 2], [0, 0, 1.0]])
    maps = undistortion_maps(cam, *hw)
    cfg = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=8,
                         live_viewer_path=os.path.join(
                             os.path.dirname(video_path), "viewer.html"),
                         live_viewer_every=5)
    pipe = OdometryPipeline(K, cfg, undistortion_maps=maps, device=dev)
    closer = LoopCloser(K, LoopClosureConfig(
        min_gap=max(args.frames // (2 * (args.skip + 1)), 10),
        min_inliers=40, rel_pose_samples=300), device=dev)

    vs = VideoStream(video_path, num_skips=args.skip)
    ok, streamed_idx, frame_ms = [], [], []
    t0 = time.perf_counter()
    for frame in vs:
        tf = time.perf_counter()
        accepted = bool(pipe.process_frame(frame, vs.frame_index))
        frame_ms.append((time.perf_counter() - tf) * 1e3)
        ok.append(accepted)
        streamed_idx.append(vs.frame_index)
        if accepted:
            closer.add_frame(pipe._prev_keypoints)
        print(f"video frame {vs.frame_index}: "
              f"{'ok' if accepted else 'REJECTED'} "
              f"({pipe.point_cloud.num_points} pts, {frame_ms[-1]:.0f} ms)",
              file=sys.stderr, flush=True)
    elapsed = time.perf_counter() - t0
    vs.close()

    accepted = sum(ok)
    gt_sel = centers[np.asarray(streamed_idx)[np.flatnonzero(ok)]]
    ate_before = float(ate_rmse(pipe.pose_graph.trajectory(), gt_sel))
    closed = bool(closer.close(pipe, accepted - 1))
    ate_after = float(ate_rmse(pipe.pose_graph.trajectory(), gt_sel))

    steady = (float(np.median(frame_ms[10:])) if len(frame_ms) > 20
              else float("nan"))
    artifact = {
        "config": "video-vo-room-loop",
        "scene": room_scene(),
        "backend": dev.type,
        "video": {"frames_encoded": args.frames, "num_skips": args.skip,
                  "frames_streamed": len(ok), "size_kb": round(size_kb, 1),
                  "codec": "mp4v"},
        "distortion": {"model": "brown_conrady",
                       "k": [-0.22, 0.05, 0.0], "p": [1e-3, -5e-4]},
        "resolution": list(hw),
        "accepted": accepted,
        "fps": round(accepted / elapsed, 3),
        "steady_ms_per_frame": round(steady, 1),
        "ate_before_closure": round(ate_before, 5),
        "loop_closed": closed,
        "ate_after_closure": round(ate_after, 5),
        "map_points": int(pipe.point_cloud.num_points),
    }
    print(json.dumps(artifact))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(f"artifact written to {args.out}", file=sys.stderr)
    return artifact


if __name__ == "__main__":
    main()
