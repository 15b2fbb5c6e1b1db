"""Homography estimation demo (4-point DLT + RANSAC) on the PyTorch / CUDA
port.

Twin of ``examples/homography_estimation_demo.py`` (reference:
cpp/examples/Sara/MultiViewGeometry/homography_estimation_example.cpp —
SIFT matches, 4-point RANSAC homography, inlier visualization). It imports
only ``sara_tpu_torch`` and runs on the card unless ``--cpu`` is given;
without a card it raises.

With no second image the demo warps the input by a known homography and
checks the recovered H against it (corner transfer error). With no
``--image-a`` the input is frame A of the synthetic pair
(``sara_tpu_torch.io.datasets.synthetic_image_pair``) at ``--width``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H_GT = np.array([[0.95, 0.08, 12.0],
                 [-0.05, 1.02, -6.0],
                 [6e-5, -4e-5, 1.0]])


def corner_transfer_error(H, H_gt, h, w):
    """Pixel distance between the image corners mapped by H and by H_gt."""
    corners = np.array([[0, 0, 1], [w - 1, 0, 1],
                        [0, h - 1, 1], [w - 1, h - 1, 1]], float)
    pa = corners @ H.T
    pb = corners @ H_gt.T
    return np.linalg.norm(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:],
                          axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-a", default=None)
    ap.add_argument("--image-b", default=None)
    ap.add_argument("--width", type=int, default=640,
                    help="width of the synthetic frame (no --image-a)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "sara_tpu_torch_homography"))
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.image.transform import warp_homography
    from sara_tpu_torch.io.datasets import synthetic_image_pair
    from sara_tpu_torch.io.image import imread_gray
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.ransac.estimators import estimate_homography

    dev = resolve_device("cpu" if args.cpu else None)
    img_a = (imread_gray(args.image_a) if args.image_a
             else synthetic_image_pair(args.width)[0])
    h, w = img_a.shape

    H_gt = None
    if args.image_b:
        img_b = imread_gray(args.image_b)
    else:
        H_gt = H_GT
        img_b = warp_homography(torch.as_tensor(img_a, device=dev),
                                torch.as_tensor(np.linalg.inv(H_gt)),
                                h, w).cpu().numpy()

    params = SIFTParams()
    ka = compute_sift_keypoints(img_a, params, device=dev)
    kb = compute_sift_keypoints(img_b, params, device=dev)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    print(f"keypoints {int(ka.count())}/{int(kb.count())}, "
          f"matches {int(m.count())}")

    res = estimate_homography(torch.Generator(device=dev).manual_seed(0),
                              ka.xy, kb.xy[m.j.long()], m.mask,
                              threshold=3.0, num_samples=500)
    H = res.model.double().cpu().numpy()
    H /= H[2, 2]
    print(f"RANSAC: success={bool(res.success)}, "
          f"inliers {int(res.num_inliers)}/{int(m.count())}")

    err = None
    if H_gt is not None:
        err = corner_transfer_error(H, H_gt, h, w)
        print(f"corner transfer error vs ground truth: "
              f"max {err.max():.3f} px")

    # Inlier match visualization.
    os.makedirs(args.out, exist_ok=True)
    try:
        from sara_tpu_torch.viz.draw import draw_matches

        inliers = m._replace(mask=m.mask & res.inliers)
        draw_matches(img_a, img_b, ka, kb, inliers,
                     os.path.join(args.out, "inlier_matches.png"))
        print(f"wrote {args.out}/inlier_matches.png")
    except ImportError as e:               # no matplotlib on this machine
        print(f"(visualization skipped: {e})")
    return dict(H=H, H_gt=H_gt, corner_err=err, ka=ka, kb=kb, matches=m,
                ransac=res)


if __name__ == "__main__":
    main()
