"""Frontend time / quality sweep over configurations that cut the op count,
on the PyTorch / CUDA port.

Twin of ``scripts/probe_frontend_sweep.py``. Its ``configs()`` are the
probe's six, field for field, from the port's ``SIFTParams()`` (whose one
deviation from the reference's defaults is ``low_precision=False``):

  base          the defaults (first octave -1, capacity 4096, refine 2)
  oct4          max_octaves=4
  refine2       refine_iters=2
  oct4+ref2     both
  cap4096       capacity 4096, total 8192
  cap4096+o4r2  all three

Modes (the first positional argument, as the probe's):

- ``time`` (default): warm ms per frame of ``compute_sift_keypoints`` for
  each configuration, the median of 10 calls after a warm-up call (CUDA
  events after a synchronize on the card, the host clock on the CPU);
- ``quality``: keypoints, correct matches (ratio 0.8) and repeatability of
  each configuration on the quality tool's homography warp
  (``scripts/torch_eval_detection_quality.py``) against OpenCV's SIFT on
  the CPU where ``cv2`` is installed; without it the warp is
  ``torch_bench.warp_without_cv2``'s and the line says the baseline is
  absent.

The frame is ``torch_bench.probe_frames``' first (the reference's
photograph, else a render of ``make_room(seed=1)``), printed. It imports
only ``sara_tpu_torch``, numpy, ``torch_bench`` and the quality tool's
twin (cv2 where present), and runs on the card unless ``--device cpu`` is
given; without a card it raises.

Usage: python scripts/torch_probe_frontend_sweep.py [time|quality]
       [--hw 480x640] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ITERS = 10


def configs():
    """The probe's six configurations, name -> ``SIFTParams``."""
    from sara_tpu_torch.features.api import SIFTParams

    base = SIFTParams()
    return {
        "base": base,
        "oct4": dataclasses.replace(base, pyramid=dataclasses.replace(
            base.pyramid, max_octaves=4)),
        "refine2": dataclasses.replace(base, dog=dataclasses.replace(
            base.dog, refine_iters=2)),
        "oct4+ref2": dataclasses.replace(
            base,
            pyramid=dataclasses.replace(base.pyramid, max_octaves=4),
            dog=dataclasses.replace(base.dog, refine_iters=2)),
        "cap4096": dataclasses.replace(
            base, dog=dataclasses.replace(base.dog, capacity=4096),
            total_capacity=8192),
        "cap4096+o4r2": dataclasses.replace(
            base,
            pyramid=dataclasses.replace(base.pyramid, max_octaves=4),
            dog=dataclasses.replace(base.dog, capacity=4096,
                                    refine_iters=2),
            total_capacity=8192),
    }


def main_quality(img, dev) -> dict:
    import torch

    import torch_bench
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.matching import MatchParams, match_descriptors

    q = torch_bench.quality_tool()
    h, w = img.shape
    H = q.make_warp(h, w)
    try:
        import cv2  # noqa: F401
        have_cv = True
    except ImportError:
        have_cv = False
    out = {}
    if have_cv:
        warped = q.warp_image(img, H)
        xy_cv_a, xy_cv_b, pairs_cv, _ = q.run_opencv(img, warped)
        cor_cv, _ = q.match_quality(xy_cv_a, xy_cv_b, pairs_cv, H)
        print(f"opencv: kp {len(xy_cv_a)} correct {cor_cv}", flush=True)
        out["opencv"] = {"kp": len(xy_cv_a), "correct": cor_cv}
    else:
        warped = torch_bench.warp_without_cv2(img, H, dev)
        print("opencv: absent (no cv2): no baseline, the warp by "
              "warp_homography with zeros at the border", flush=True)
    n_cv = out.get("opencv", {}).get("kp")
    c_cv = out.get("opencv", {}).get("correct")

    def ratio(a, b):
        return "(n/a)" if b is None else f"({a / max(b, 1):.3f}x)"

    ia, ib = (torch.as_tensor(x).to(dev, torch.float32)
              for x in (img, warped))
    for name, p in configs().items():
        ka = compute_sift_keypoints(ia, p, device=dev)
        kb = compute_sift_keypoints(ib, p, device=dev)
        m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
        sel_a = ka.mask.cpu().numpy()
        sel_b = kb.mask.cpu().numpy()
        xy_a = ka.xy.cpu().numpy()[sel_a]
        xy_b = kb.xy.cpu().numpy()[sel_b]
        remap_a = np.cumsum(sel_a) - 1
        remap_b = np.cumsum(sel_b) - 1
        mm = m.mask.cpu().numpy()
        mi = remap_a[m.i.cpu().numpy()[mm]]
        mj = remap_b[m.j.cpu().numpy()[mm]]
        cor, _ = q.match_quality(xy_a, xy_b, np.stack([mi, mj], 1), H)
        rep, _ = q.repeatability(xy_a, xy_b, H, h, w)
        print(f"{name:10s} kp {len(xy_a):5d} {ratio(len(xy_a), n_cv)} "
              f"correct {cor:5d} {ratio(cor, c_cv)} rep {rep:.3f}",
              flush=True)
        out[name] = {"kp": len(xy_a), "correct": int(cor), "rep": rep}
    return out


def main_time(img, dev) -> dict:
    import torch

    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.utils.timing import median_ms

    a = torch.as_tensor(img).to(dev)
    out = {}
    for name, p in configs().items():
        kp, dt, first = median_ms(
            lambda p=p: compute_sift_keypoints(a, p, device=dev), dev, ITERS)
        n = int(kp.count())
        print(f"{name:10s} {dt:7.1f} ms/frame warm  ({n} kp, "
              f"first call {first:.1f}s)", flush=True)
        out[name] = {"ms": dt, "kp": n}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="time",
                    choices=("time", "quality"))
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch_bench
    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    (img,), source = torch_bench.probe_frames(1, h, w)
    print("device:", dev, "mode:", args.mode, "input:", source, flush=True)
    return (main_quality if args.mode == "quality" else main_time)(img, dev)


if __name__ == "__main__":
    main()
