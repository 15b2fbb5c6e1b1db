"""Monocular visual odometry demo (BASELINE configs 2/3) on the PyTorch /
CUDA port.

Twin of ``examples/visual_odometry_demo.py`` (reference:
cpp/examples/Sara/MultiViewGeometry/visual_odometry_example.cpp:555-623 —
video stream, frame skipping, hardcoded intrinsics, OdometryPipeline). It
imports only ``sara_tpu_torch`` and runs on the card unless ``--cpu`` is
given; without a card it raises.

Runs either on a video file (--video) or on a synthetic generated sequence
(--synthetic, default) when no data is available: the keypoint-level
sequence of the JAX demo (cameras orbiting a seeded point cloud, planted
descriptors), made here in NumPy. Outputs trajectory plot + PLY point
cloud.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_sequence(n_frames=10, n_points=300, noise=0.3, seed=0,
                  capacity=512):
    """Cameras orbiting a point cloud (the JAX demo's synthetic sequence,
    ``tests/test_sfm_pipeline.py::_make_sequence``): the fields of each
    frame's keypoint set as NumPy arrays, the true camera centres and K."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-4, 4, (n_points, 3)) + np.array([0, 0, 12.0])
    # Spread points along the forward path so long sequences (the camera
    # advances 0.5 units/frame) never run out of visible scene.
    X[:, 2] = rs.uniform(8.0, 12.0 + 0.5 * n_frames, n_points)
    desc = rs.normal(size=(n_points, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[800.0, 0, 512.0], [0, 800.0, 384.0], [0, 0, 1.0]])

    frames, centers = [], []
    for f in range(n_frames):
        # Bounded yaw sweep: an unboundedly growing yaw turns the camera
        # away from the (forward-distributed) scene on long sequences.
        ang = 0.35 * np.sin(0.1 * f)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([2.0 * np.sin(0.1 * f), 0.1 * f, 0.5 * f])
        t = -R @ c
        centers.append(c)
        Xc = X @ R.T + t
        vis = Xc[:, 2] > 1.0
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        vis &= ((uv[:, 0] >= 0) & (uv[:, 0] < 1024) & (uv[:, 1] >= 0)
                & (uv[:, 1] < 768))
        idx = np.nonzero(vis)[0][:capacity]
        n = len(idx)
        xy = np.zeros((capacity, 2), np.float32)
        xy[:n] = uv[idx] + rs.normal(scale=noise, size=(n, 2))
        d = np.zeros((capacity, 128), np.float32)
        d[:n] = desc[idx]
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        frames.append((xy, np.full(capacity, 2.0, np.float32),
                       np.zeros(capacity, np.float32),
                       np.where(mask, 1.0, 0.0).astype(np.float32), d, mask))
    return frames, np.asarray(centers), K


def run_video(args, dev):
    import dataclasses

    from sara_tpu_torch.io.video import VideoStream
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline

    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1.0]])
    cfg = OdometryConfig()
    if args.live_viewer:
        cfg = dataclasses.replace(
            cfg, live_viewer_path=os.path.join(args.out, "viewer.html"),
            live_viewer_every=args.live_viewer)
    pipe = OdometryPipeline(K, cfg, device=dev)
    vs = VideoStream(args.video, num_skips=args.skip)
    n = 0
    for frame in vs:
        ok = pipe.process_frame(frame, vs.frame_index)
        n += 1
        print(f"frame {vs.frame_index}: {'pose added' if ok else 'rejected'}; "
              f"{len(pipe.pose_graph)} poses, "
              f"{pipe.point_cloud.num_points} points")
        if args.max_frames and n >= args.max_frames:
            break
    return pipe


def run_synthetic(args, dev, log):
    from sara_tpu_torch.convert import keypoints_from_numpy
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.utils import ate_rmse

    frames, centers_gt, K = make_sequence(n_frames=args.max_frames or 20,
                                          noise=0.3)
    pipe = OdometryPipeline(K, OdometryConfig(
        rel_pose_samples=200, pnp_samples=200,
        rel_pose_min_inliers=50, pnp_min_inliers=20,
        live_viewer_path=(os.path.join(args.out, "viewer.html")
                          if args.live_viewer else ""),
        live_viewer_every=args.live_viewer or 5), device=dev)
    for f, fields in enumerate(frames):
        ok = pipe.process_keypoints(keypoints_from_numpy(fields, dev), f)
        log.append((f, bool(ok), pipe.point_cloud.num_points))
        print(f"frame {f}: {'pose added' if ok else 'rejected'}; "
              f"{pipe.point_cloud.num_points} points")
    err = ate_rmse(pipe.pose_graph.trajectory(), centers_gt)
    print(f"ATE-RMSE vs ground truth: {err:.4f}")
    return pipe, centers_gt, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sara_tpu_torch_vo"))
    ap.add_argument("--max-frames", type=int, default=20)
    ap.add_argument("--skip", type=int, default=4)
    ap.add_argument("--fx", type=float, default=800.0)
    ap.add_argument("--fy", type=float, default=800.0)
    ap.add_argument("--cx", type=float, default=640.0)
    ap.add_argument("--cy", type=float, default=360.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--live-viewer", type=int, default=0, metavar="K",
                    help="rewrite <out>/viewer.html every K accepted frames "
                         "(open it in a browser to watch the cloud + "
                         "trajectory grow mid-run); 0 disables")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.viz import draw_trajectory

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    gt = ate = None
    frames = []
    if args.video:
        pipe = run_video(args, dev)
    else:
        pipe, gt, ate = run_synthetic(args, dev, frames)

    try:
        draw_trajectory(pipe.pose_graph.trajectory(), gt,
                        os.path.join(args.out, "trajectory.png"))
    except ImportError as e:               # no matplotlib on this machine
        print(f"(visualization skipped: {e})")
    pipe.point_cloud.write_ply(os.path.join(args.out, "cloud.ply"))
    print(f"wrote outputs to {args.out}")
    return dict(frames=frames, ate=ate, poses=len(pipe.pose_graph),
                points=pipe.point_cloud.num_points)


if __name__ == "__main__":
    main()
