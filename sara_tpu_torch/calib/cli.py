"""Camera calibration CLI: chessboard video/images -> intrinsics JSON.

Twin of the JAX package's ``scripts/calibrate_camera.py``, with the same
arguments (plus ``--device``), the same transpose rule for a (cols, rows)
detection and the same JSON output: stream frames, detect ordered
chessboard corners, accumulate views, then solve one joint problem (Zhang
init + LM over intrinsics/distortion/poses; ``--fix-distortion`` freezes
the distortion) with an RMS warning gate. The device programs run on the
CUDA card unless ``--device cpu`` asks for the CPU.

Usage:
  python -m sara_tpu_torch.calib.cli --images 'frames/*.png' \
      --rows 6 --cols 9 --square-size 0.025 [--model omnidirectional] \
      [--max-views 20] [--rms-max 2.0] [--device cpu] -o intrinsics.json
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def iter_frames(args):
    if args.images:
        for path in sorted(glob.glob(args.images)):
            from sara_tpu_torch.io.image import imread_gray
            yield path, imread_gray(path)
    elif args.video:
        from sara_tpu_torch.io.video import VideoStream
        stream = VideoStream(args.video, num_skips=args.skip)
        for k, frame in enumerate(stream):
            g = frame.mean(axis=-1) if frame.ndim == 3 else frame
            yield f"{args.video}#{k}", np.asarray(g, np.float32) / 255.0
    else:
        raise SystemExit("need --images or --video")


def collect_views(frames, rows: int, cols: int, max_views: int = 20,
                  device=None) -> list:
    """Ordered (rows * cols, 2) corners of each (name, gray) frame whose
    detection is a (rows, cols) grid, at most ``max_views`` of them. A
    (cols, rows) detection is the same board turned by 90 degrees and is
    transposed to the (rows, cols) model (square squares leave the
    intrinsics unchanged); any other frame is skipped."""
    from sara_tpu_torch.calib.chessboard import detect_chessboard_corners

    views = []
    for name, gray in frames:
        if len(views) >= max_views:
            break
        corners, _ok = detect_chessboard_corners(gray, device=device)
        shape = None if corners is None else np.asarray(corners).shape[:2]
        if shape == (cols, rows) and rows != cols:
            corners = np.asarray(corners).transpose(1, 0, 2)
            shape = (rows, cols)
        if shape != (rows, cols):
            log(f"[skip] {name}: no ({rows}x{cols}) grid (got {shape})")
            continue
        views.append(np.asarray(corners).reshape(-1, 2))
        log(f"[view {len(views)}] {name}")
    return views


def calibrate_views(views: list, rows: int, cols: int,
                    square_size: float = 1.0, model: str = "pinhole",
                    fix_distortion: bool = False, device=None) -> dict:
    """One joint calibration of the collected views against the planar
    (rows, cols) model of ``square_size`` squares."""
    from sara_tpu_torch.calib.calibrate import (calibrate_omnidirectional,
                                                calibrate_pinhole)

    model_xy = (np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                         axis=-1).reshape(-1, 2).astype(np.float64)
                * square_size)
    obj = np.broadcast_to(model_xy, (len(views),) + model_xy.shape).copy()
    img = np.stack(views)
    if model == "pinhole":
        return calibrate_pinhole(obj, img, fix_distortion=fix_distortion,
                                 device=device)
    return calibrate_omnidirectional(obj, img, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", help="glob of chessboard frames")
    ap.add_argument("--video", help="video file of the chessboard")
    ap.add_argument("--skip", type=int, default=4,
                    help="frames to skip between video samples")
    ap.add_argument("--rows", type=int, required=True,
                    help="inner corner rows")
    ap.add_argument("--cols", type=int, required=True,
                    help="inner corner cols")
    ap.add_argument("--square-size", type=float, default=1.0,
                    help="board square size (meters or arbitrary units)")
    ap.add_argument("--model", choices=["pinhole", "omnidirectional"],
                    default="pinhole")
    ap.add_argument("--max-views", type=int, default=20)
    ap.add_argument("--rms-max", type=float, default=2.0,
                    help="reject calibration if RMS above this (pixels)")
    ap.add_argument("--fix-distortion", action="store_true",
                    help="freeze distortion at zero (pinhole only)")
    ap.add_argument("-o", "--output", default="intrinsics.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the device programs (default: "
                         "the CUDA card; 'cpu' runs them on the CPU)")
    args = ap.parse_args(argv)

    views = collect_views(iter_frames(args), args.rows, args.cols,
                          args.max_views, args.device)
    if len(views) < 3:
        raise SystemExit(f"only {len(views)} usable views; need >= 3")
    result = calibrate_views(views, args.rows, args.cols, args.square_size,
                             args.model, args.fix_distortion, args.device)

    if result["rms"] > args.rms_max:
        log(f"WARNING: RMS {result['rms']:.3f} px exceeds "
            f"--rms-max {args.rms_max}; calibration NOT trustworthy")

    out = {
        "model": args.model,
        "K": np.asarray(result["K"]).tolist(),
        "dist": np.asarray(result["dist"]).tolist(),
        "rms": result["rms"],
        "num_views": len(views),
    }
    if "xi" in result:
        out["xi"] = result["xi"]
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {args.output} (rms {result['rms']:.3f} px, "
        f"{len(views)} views)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
