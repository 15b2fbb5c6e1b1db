"""Knob sweep of match quality on the weak scenes, on the PyTorch / CUDA
port.

Twin of ``scripts/probe_dog_quality.py``. For each scene, the port's SIFT
(``compute_sift_keypoints``, first_octave -1, capacity ``--cap``, the
"gather" sampler) and matcher (``match_descriptors``, ratio 0.8) run on
the scene and on its warp by the quality tool's similarity homography,
under the probe's four settings of the sampling knobs (the orientation
maps' stride ``orientation_downsample`` 1 or 2, nearest or bilinear
descriptor sampling, bilinear histogram sampling), scored by the quality
tool's twin (``scripts/torch_eval_detection_quality.py``: correct matches
within 3 px of the homography, repeatability within 2 px) against
OpenCV's SIFT on the same task.

A scene is the reference's photograph where it exists; the scenes that
are missing are stood for, once, by ``torch_bench.probe_frames``' render
of ``make_room(seed=1)``; the source is printed. The warp and the OpenCV
baseline go through cv2 where it is installed; without it the warp is
``torch_bench.warp_without_cv2``'s (zeros at the border where cv2
reflects) and the baseline and the ratios against it are null.

Prints the probe's JSON lines (each row also carries both keypoint
counts) and returns them. It imports only ``sara_tpu_torch``, numpy,
``torch_bench`` and the quality tool's twin, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_dog_quality.py [--scenes dog.jpg,...]
       [--cap 8192] [--hw 480x640] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The probe's four settings of the knobs.
CONFIGS = [
    ("prod_tpu: ds2 desc-near hist-bilin", dict(ds=2, desc_nearest=True,
                                                hist_nearest=False)),
    ("ds2 desc-BILIN hist-bilin", dict(ds=2, desc_nearest=False,
                                       hist_nearest=False)),
    ("ds1 desc-near hist-bilin", dict(ds=1, desc_nearest=True,
                                      hist_nearest=False)),
    ("ds1 desc-BILIN hist-bilin", dict(ds=1, desc_nearest=False,
                                       hist_nearest=False)),
]


def match_sets(img_a, img_b, params, device=None):
    """The port's SIFT with ``params`` on both images (numpy arrays or
    tensors) and its matcher (ratio 0.8) on ``device`` (None = the card):
    the valid keypoints' positions of each side and the matches as (M, 2)
    indices into them."""
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.matching import MatchParams, match_descriptors

    dev = resolve_device(device)
    ka = compute_sift_keypoints(img_a, params, device=dev)
    kb = compute_sift_keypoints(img_b, params, device=dev)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    mask_a, mask_b = ka.mask.cpu().numpy(), kb.mask.cpu().numpy()
    xy_a = ka.xy.cpu().numpy()[mask_a]
    xy_b = kb.xy.cpu().numpy()[mask_b]
    mm = m.mask.cpu().numpy()
    mi, mj = m.i.cpu().numpy()[mm], m.j.cpu().numpy()[mm]
    # Match indices (capacity slots) into the compacted arrays; a match
    # can only join valid slots.
    keep = mask_a[mi] & mask_b[mj]
    ra, rb = np.cumsum(mask_a) - 1, np.cumsum(mask_b) - 1
    pairs = np.stack([ra[mi[keep]], rb[mj[keep]]], axis=1).reshape(-1, 2)
    return xy_a, xy_b, pairs


def run_with(img_a, img_b, ds, desc_nearest, hist_nearest, sampler="gather",
             cap=8192, device=None):
    """The probe's ``run_with``: first_octave -1, per-octave capacity
    ``cap // 2`` (5 refinements), total ``cap``, the knobs as given."""
    from sara_tpu_torch.features import SIFTParams
    from sara_tpu_torch.features.dog import DoGParams
    from sara_tpu_torch.image.pyramid import PyramidParams

    params = SIFTParams(
        pyramid=PyramidParams(first_octave=-1),
        dog=DoGParams(capacity=cap // 2),
        total_capacity=cap,
        orientation_downsample=ds,
        desc_sample_nearest=desc_nearest,
        hist_sample_nearest=hist_nearest,
        desc_sampler=sampler,
    )
    return match_sets(img_a, img_b, params, device)


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def warp_pair(q, img, device):
    """(warped, H, OpenCV's {"kp", "correct", "matches"} or None): ``img``
    warped by the quality tool's homography, by cv2 where it is installed
    (OpenCV's SIFT scored on the same pair), else by
    ``torch_bench.warp_without_cv2`` on ``device`` with no baseline."""
    import torch_bench

    h, w = img.shape
    H = q.make_warp(h, w)
    if not have_cv2():
        return torch_bench.warp_without_cv2(img, H, device), H, None
    warped = q.warp_image(img, H)
    xy_a, xy_b, pairs, _ = q.run_opencv(img, warped)
    cor, n = q.match_quality(xy_a, xy_b, pairs, H)
    return warped, H, {"kp": len(xy_a), "correct": cor, "matches": n}


def scenes(names, h, w) -> list:
    """(name, image, source) of each scene of ``names`` whose photograph
    exists, then one ``torch_bench.probe_frames`` render standing for all
    those that are missing."""
    import torch_bench
    from sara_tpu_torch.io.datasets import REFERENCE_DATA

    out, missing = [], []
    for name in names:
        path = os.path.join(REFERENCE_DATA, name)
        if os.path.exists(path):
            out.append((name, torch_bench._read_gray(path, h, w),
                        f"photograph {name}"))
        else:
            missing.append(name)
    if missing:
        (img,), source = torch_bench.probe_frames(1, h, w)
        out.append(("+".join(missing), img,
                    f"{source} (standing for {', '.join(missing)})"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="dog.jpg,GuardOnBlonde.tif,"
                    "sunflowerField.jpg")
    ap.add_argument("--cap", type=int, default=8192)
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch_bench
    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    q = torch_bench.quality_tool()
    rows = []
    for name, im, source in scenes(args.scenes.split(","), h, w):
        print("device:", dev, "input:", source, "warp:",
              "cv2" if have_cv2() else "warp_homography on the device "
              "(zeros at the border; no cv2, no OpenCV baseline)",
              flush=True)
        warped, H, cv = warp_pair(q, im, dev)
        cv = cv or {"correct": None, "matches": None}
        cor_cv = cv["correct"]
        print(json.dumps({"scene": name, "opencv_correct": cor_cv,
                          "opencv_matches": cv["matches"]}), flush=True)
        for label, kw in CONFIGS:
            t0 = time.perf_counter()
            xy_a, xy_b, pairs = run_with(im, warped, cap=args.cap,
                                         device=dev, **kw)
            cor, n = q.match_quality(xy_a, xy_b, pairs, H)
            rep, _ = q.repeatability(xy_a, xy_b, H, h, w)
            row = {"scene": name, "config": label, "correct": cor,
                   "matches": n,
                   "correct_ratio_vs_cv": (None if cor_cv is None else
                                           round(cor / max(cor_cv, 1), 4)),
                   "repeatability": round(rep, 4),
                   "wall_s": round(time.perf_counter() - t0, 1),
                   "kp": [len(xy_a), len(xy_b)]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
