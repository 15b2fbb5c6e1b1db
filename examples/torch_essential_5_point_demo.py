"""Five-point essential matrix walkthrough (minimal-solver demo) on the
PyTorch / CUDA port.

Twin of ``examples/essential_5_point_demo.py`` (reference:
cpp/examples/Sara/MultiViewGeometry/essential_5_point_example.cpp — detect
SIFT on an image pair, match, run the 5-point solver inside RANSAC, recover
(R, t), triangulate, and report epipolar residuals). It imports only
``sara_tpu_torch`` and runs on the card unless ``--cpu`` is given; without
a card it raises.

When no second view is given, the second view is a known synthetic warp of
the first, so the recovered geometry can be checked against ground truth.
With no ``--image-a`` the first view is frame A of the synthetic pair
(``sara_tpu_torch.io.datasets.synthetic_image_pair``) at ``--width``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W_GT = np.array([0.02, 0.08, 0.01])       # relative rotation, angle-axis
T_GT = np.array([0.08, 0.0, 0.02])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-a", default=None)
    ap.add_argument("--image-b", default=None,
                    help="second view (default: synthetic rotated view of "
                         "--image-a with known ground truth)")
    ap.add_argument("--width", type=int, default=640,
                    help="width of the synthetic frame (no --image-a)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--samples", type=int, default=500)
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.io.datasets import synthetic_image_pair
    from sara_tpu_torch.io.image import imread_gray
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.mvg.two_view import (sampson_epipolar_distance,
                                             triangulate_linear)
    from sara_tpu_torch.ransac import estimate_relative_pose

    dev = resolve_device("cpu" if args.cpu else None)
    img_a = (imread_gray(args.image_a) if args.image_a
             else synthetic_image_pair(args.width)[0])
    h, w = img_a.shape
    K = np.array([[0.9 * w, 0.0, w / 2], [0.0, 0.9 * w, h / 2], [0, 0, 1.0]])

    if args.image_b:
        img_b = imread_gray(args.image_b)
        R_gt = t_gt = None
    else:
        # Synthetic second view: a plane-induced homography warp with a
        # known relative rotation and translation, so the 5-point problem
        # is well posed.
        from sara_tpu_torch.core.lie import so3_exp
        from sara_tpu_torch.image.transform import warp_homography

        R_gt = so3_exp(torch.as_tensor(W_GT)).numpy()
        t_gt = T_GT
        n_plane = np.array([0.0, 0.0, 1.0])
        d_plane = 4.0
        H_gt = K @ (R_gt + np.outer(t_gt, n_plane) / d_plane) @ np.linalg.inv(K)
        img_b = warp_homography(torch.as_tensor(img_a, device=dev),
                                torch.as_tensor(np.linalg.inv(H_gt)),
                                h, w).cpu().numpy()

    print(f"views: {img_a.shape} / {img_b.shape}")
    params = SIFTParams()
    ka = compute_sift_keypoints(img_a, params, device=dev)
    kb = compute_sift_keypoints(img_b, params, device=dev)
    print(f"keypoints: {int(ka.count())} / {int(kb.count())}")

    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    print(f"putative matches: {int(m.count())}")

    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    res, R, t = estimate_relative_pose(
        torch.Generator(device=dev).manual_seed(0), ka.xy,
        kb.xy[m.j.long()], m.mask, Kt, Kt, threshold_px=2.0,
        num_samples=args.samples, min_inliers=30)
    n_inl = int(res.num_inliers)
    print(f"5-point RANSAC: success={bool(res.success)}, "
          f"inliers {n_inl}/{int(m.count())}")

    # Epipolar residuals of the inliers (normalized coordinates).
    Kinv = np.linalg.inv(K)
    ua = ka.xy.cpu().numpy()
    ub = kb.xy.cpu().numpy()[m.j.cpu().numpy()]
    un = (np.c_[ua, np.ones(len(ua))] @ Kinv.T)[:, :2]
    vn = (np.c_[ub, np.ones(len(ub))] @ Kinv.T)[:, :2]
    f32 = dict(dtype=torch.float32, device=dev)
    d = sampson_epipolar_distance(res.model, torch.as_tensor(un, **f32),
                                  torch.as_tensor(vn, **f32)).cpu().numpy()
    inl = res.inliers.cpu().numpy()
    med = float(np.median(d[inl]))
    print(f"median Sampson residual (inliers): {med:.2e}")

    R = R.double().cpu().numpy()
    t = t.double().cpu().numpy()
    t = t / np.linalg.norm(t)
    rerr = terr = None
    if R_gt is not None:
        rerr = float(np.degrees(np.arccos(np.clip(
            (np.trace(R.T @ R_gt) - 1) / 2, -1, 1))))
        terr = float(np.degrees(np.arccos(np.clip(
            abs(t @ (t_gt / np.linalg.norm(t_gt))), -1, 1))))
        print(f"vs ground truth: rotation err {rerr:.3f} deg, "
              f"translation direction err {terr:.3f} deg")

    # Triangulate the inliers and report cheirality.
    ra = np.c_[un, np.ones(len(un))]
    rb = np.c_[vn, np.ones(len(vn))]
    X, d1, d2 = triangulate_linear(torch.as_tensor(R, **f32),
                                   torch.as_tensor(t, **f32),
                                   torch.as_tensor(ra, **f32),
                                   torch.as_tensor(rb, **f32))
    cheiral = ((d1 > 0) & (d2 > 0)).cpu().numpy() & inl
    print(f"triangulated {int(cheiral.sum())} points in front of both views")
    return dict(inliers=n_inl, matches=int(m.count()), sampson_median=med,
                rotation_err_deg=rerr, direction_err_deg=terr,
                cheiral=int(cheiral.sum()), success=bool(res.success))


if __name__ == "__main__":
    main()
