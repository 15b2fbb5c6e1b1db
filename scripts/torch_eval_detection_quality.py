"""Detection and matching quality of the PyTorch / CUDA port: its SIFT
against OpenCV's SIFT.

Twin of ``scripts/eval_detection_quality.py``. On one image and its warp by
a known similarity homography it measures:
  - keypoint counts (the port's and OpenCV's) on the same image;
  - repeatability: the fraction of source keypoints, projected into the
    warped image, with a detection within eps px;
  - correct matches: descriptor matches that the homography confirms (<3
    px), the port's against OpenCV's.

``run_ours`` runs the port's frontend (``compute_sift_keypoints`` with the
kernel sampler: the CUDA patch sampler on the card, its plain version on
the CPU) and its matcher (``MatchParams(ratio=0.8)``), timed with a
``synchronize()`` before each clock read. The warp and the OpenCV baseline
go through ``cv2``, imported where they are called, so without it ``main``
raises. The image is ``--image`` (default: the reference's photograph);
there is no procedural fallback, as the tool has none. It logs the tool's
three lines to stderr and prints the same numbers as its last line of
stdout, one JSON object, also written to ``--out``.

It imports only ``sara_tpu_torch`` and numpy (PIL to read the image), and
runs on the card unless ``--device cpu`` is given; without a card it
raises.

Usage: python scripts/torch_eval_detection_quality.py [--first-octave -1]
       [--image path] [--device cpu] [--out torch_eval_detection_quality.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sara_tpu_torch.io.datasets import REFERENCE_DATA


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_image(path=os.path.join(REFERENCE_DATA, "sunflowerField.jpg"),
               h=480, w=640):
    import PIL.Image

    img = PIL.Image.open(path).convert("L").resize((w, h))
    return np.asarray(img, np.float32) / 255.0


def make_warp(h, w, angle_deg=12.0, scale=0.9, tx=20.0, ty=-12.0):
    """Similarity homography about the image center (3x3, maps src->dst)."""
    c, s = np.cos(np.deg2rad(angle_deg)), np.sin(np.deg2rad(angle_deg))
    cx, cy = w / 2.0, h / 2.0
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    R = np.array([[scale * c, -scale * s, tx], [scale * s, scale * c, ty],
                  [0, 0, 1]], np.float64)
    T2 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
    return T2 @ R @ T1


def warp_image(img, H):
    import cv2

    h, w = img.shape
    return cv2.warpPerspective(img, H.astype(np.float64), (w, h),
                               flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT)


def project(H, xy):
    p = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def interior_mask(xy, h, w, b=10):
    return ((xy[:, 0] >= b) & (xy[:, 0] < w - b) &
            (xy[:, 1] >= b) & (xy[:, 1] < h - b))


def repeatability(xy_a, xy_b, H, h, w, eps=2.0):
    """Fraction of projected source kps (landing inside the warped image)
    with a detection within eps px, and how many were projected."""
    pa = project(H, xy_a)
    keep = interior_mask(pa, h, w)
    pa = pa[keep]
    if len(pa) == 0 or len(xy_b) == 0:
        return 0.0, 0
    d2 = ((pa[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    return float((d2.min(axis=1) <= eps * eps).mean()), len(pa)


def match_quality(xy_a, xy_b, matches_ab, H, eps=3.0):
    """matches_ab: (M, 2) index pairs. Returns (n_correct, n_matches)."""
    if len(matches_ab) == 0:
        return 0, 0
    pa = project(H, xy_a[matches_ab[:, 0]])
    err = np.linalg.norm(pa - xy_b[matches_ab[:, 1]], axis=1)
    return int((err <= eps).sum()), len(matches_ab)


def run_ours(img_a, img_b, first_octave, total_capacity, octave_capacity,
             orientation_downsample=0, device=None):
    """The port's SIFT on both images (numpy arrays or tensors) and its
    matcher on ``device`` (None = the card). Returns the valid keypoints'
    positions of each side, the matches as (M, 2) indices into them, and
    the seconds from the first detection to the matches."""
    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import (DoGParams, SIFTParams,
                                         compute_sift_keypoints)
    from sara_tpu_torch.image.pyramid import PyramidParams
    from sara_tpu_torch.matching import MatchParams, match_descriptors

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = SIFTParams(
        pyramid=PyramidParams(first_octave=first_octave),
        dog=DoGParams(capacity=octave_capacity),
        total_capacity=total_capacity,
        orientation_downsample=orientation_downsample,
        desc_sampler="kernel",
    )
    sync()
    t0 = time.perf_counter()
    ka = compute_sift_keypoints(img_a, params, device=dev)
    kb = compute_sift_keypoints(img_b, params, device=dev)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    sync()
    t1 = time.perf_counter()

    def unpack(k):
        mask = k.mask.cpu().numpy()
        return k.xy.cpu().numpy()[mask], mask

    xy_a, mask_a = unpack(ka)
    xy_b, mask_b = unpack(kb)
    mmask = m.mask.cpu().numpy()
    mi = m.i.cpu().numpy()[mmask]
    mj = m.j.cpu().numpy()[mmask]
    # Remap match indices (into capacity slots) to compacted arrays.
    remap_a = np.cumsum(mask_a) - 1
    remap_b = np.cumsum(mask_b) - 1
    pairs = np.stack([remap_a[mi], remap_b[mj]], axis=1)
    return xy_a, xy_b, pairs, t1 - t0


def run_opencv(img_a, img_b):
    import cv2

    a8 = (img_a * 255).astype(np.uint8)
    b8 = (img_b * 255).astype(np.uint8)
    sift = cv2.SIFT_create()
    t0 = time.perf_counter()
    ka, da = sift.detectAndCompute(a8, None)
    kb, db = sift.detectAndCompute(b8, None)
    bf = cv2.BFMatcher()
    knn = bf.knnMatch(da, db, k=2)
    good = [m for m, n in knn if m.distance < 0.8 * n.distance]
    t1 = time.perf_counter()
    xy_a = np.array([k.pt for k in ka], np.float64).reshape(-1, 2)
    xy_b = np.array([k.pt for k in kb], np.float64).reshape(-1, 2)
    pairs = np.array([[m.queryIdx, m.trainIdx] for m in good],
                     np.int64).reshape(-1, 2)
    return xy_a, xy_b, pairs, t1 - t0


def score(run, H, h, w):
    """The numbers the tool logs for one detector's ``run`` (as
    ``run_ours`` / ``run_opencv`` return it)."""
    rep, n = repeatability(run[0], run[1], H, h, w)
    cor, m = match_quality(run[0], run[1], run[2], H)
    return {"kp": [len(run[0]), len(run[1])], "seconds": run[3],
            "repeatability": rep, "projected": n, "matches": m,
            "correct": cor}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-octave", type=int, default=-1)
    ap.add_argument("--total-capacity", type=int, default=8192)
    ap.add_argument("--octave-capacity", type=int, default=4096)
    ap.add_argument("--image",
                    default=os.path.join(REFERENCE_DATA, "sunflowerField.jpg"))
    ap.add_argument("--orientation-downsample", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="torch_eval_detection_quality.json")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    img = load_image(args.image)
    h, w = img.shape
    H = make_warp(h, w)
    warped = warp_image(img, H)

    cv = score(run_opencv(img, warped), H, h, w)
    log(f"opencv: kp {cv['kp'][0]}/{cv['kp'][1]} t={cv['seconds']:.2f}s "
        f"repeatability {cv['repeatability']:.3f} ({cv['projected']} "
        f"projected) matches {cv['matches']} correct {cv['correct']}")

    ours = score(run_ours(img, warped, args.first_octave,
                          args.total_capacity, args.octave_capacity,
                          args.orientation_downsample, device=dev), H, h, w)
    log(f"ours(fo={args.first_octave}): kp {ours['kp'][0]}/{ours['kp'][1]} "
        f"t={ours['seconds']:.2f}s repeatability {ours['repeatability']:.3f} "
        f"({ours['projected']} projected) matches {ours['matches']} "
        f"correct {ours['correct']}")
    kp_ratio = ours["kp"][0] / max(cv["kp"][0], 1)
    correct_ratio = ours["correct"] / max(cv["correct"], 1)
    log(f"kp ratio {kp_ratio:.2f}  correct-match ratio {correct_ratio:.2f}")

    result = {"device": str(dev), "image": args.image,
              "first_octave": args.first_octave, "size": [h, w],
              "opencv": cv, "ours": ours, "kp_ratio": kp_ratio,
              "correct_match_ratio": correct_ratio}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
