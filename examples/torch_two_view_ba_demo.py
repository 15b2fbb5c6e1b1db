"""Two-view reconstruction + bundle adjustment demo on the PyTorch / CUDA
port.

Twin of ``examples/two_view_ba_demo.py`` (reference:
cpp/examples/Sara/MultiViewGeometry/two_view_bundle_adjustment_example.cpp:
77-120+): SIFT on both images -> match -> essential RANSAC -> cheiral
triangulation -> two-view bundle adjustment -> PLY export. It imports only
``sara_tpu_torch`` and runs on the card unless ``--cpu`` is given; without
a card it raises.

Works on any image pair (``--left`` / ``--right``); by default the first
view is frame A of the synthetic pair
(``sara_tpu_torch.io.datasets.synthetic_image_pair``) at ``--width`` and the
second a small projective warp of it, so structure is recoverable without a
real stereo pair.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H_WARP = np.array([[1.02, 0.02, -8.0], [-0.015, 1.01, 5.0],
                   [1e-5, -2e-5, 1.0]])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", default=None)
    ap.add_argument("--right", default=None)
    ap.add_argument("--width", type=int, default=640,
                    help="width of the synthetic frame (no --left/--right)")
    ap.add_argument("--f", type=float, default=600.0)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "sara_tpu_torch_two_view_ba"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--self-calibrate", action="store_true",
                    help="perturb the intrinsics 5%% and let BA recover "
                    "them (intr_free; reference packs intrinsics as "
                    "parameters, BundleAdjuster.cpp:162-210)")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions, BAProblem, bundle_adjust
    from sara_tpu_torch.core import lie
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.io.image import imread_gray
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.ransac import estimate_relative_pose
    from sara_tpu_torch.sfm.pointcloud import PointCloudGenerator

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)

    if args.left and args.right:
        a = imread_gray(args.left)
        b = imread_gray(args.right)
    else:
        from sara_tpu_torch.image import warp_homography
        from sara_tpu_torch.io.datasets import synthetic_image_pair

        a = synthetic_image_pair(args.width)[0]
        # Synthetic second view: small projective warp of the first.
        H, W = a.shape
        b = warp_homography(torch.as_tensor(a, device=dev),
                            torch.as_tensor(np.linalg.inv(H_WARP)),
                            H, W).cpu().numpy()

    h, w = a.shape
    K = np.array([[args.f, 0, w / 2], [0, args.f, h / 2], [0, 0, 1.0]])

    ka = compute_sift_keypoints(a, SIFTParams(), device=dev)
    kb = compute_sift_keypoints(b, SIFTParams(), device=dev)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    print(f"keypoints {int(ka.count())}/{int(kb.count())}, "
          f"matches {int(m.count())}")

    f32 = dict(dtype=torch.float32, device=dev)
    Kt = torch.as_tensor(K, **f32)
    res, R, t = estimate_relative_pose(
        torch.Generator(device=dev).manual_seed(0), ka.xy,
        kb.xy[m.j.long()], m.mask, Kt, Kt, threshold_px=4.0,
        num_samples=1000, min_inliers=50)
    print(f"relative pose inliers: {int(res.num_inliers)} "
          f"(success={bool(res.success)})")
    out = dict(inliers=int(res.num_inliers), success=bool(res.success))
    if not bool(res.success):
        return out

    # Triangulate inliers with |t| = 1.
    from sara_tpu_torch.mvg import triangulate_linear

    inl = res.inliers.cpu().numpy()
    Ki = np.linalg.inv(K)
    ua = ka.xy.cpu().numpy()[inl]
    ub = kb.xy.cpu().numpy()[m.j.cpu().numpy()[inl]]

    def rays(p):
        return np.concatenate([p, np.ones((len(p), 1))], axis=1) @ Ki.T

    R = R.double().cpu().numpy()
    t = t.double().cpu().numpy()
    X, d1, d2 = triangulate_linear(
        torch.as_tensor(R, **f32), torch.as_tensor(t, **f32),
        torch.as_tensor(rays(ua), **f32), torch.as_tensor(rays(ub), **f32))
    X = X.cpu().numpy()
    keep = ((d1 > 0) & (d2 > 0)).cpu().numpy() & np.isfinite(X).all(axis=1)
    X, ua, ub = X[keep], ua[keep], ub[keep]
    print(f"triangulated {len(X)} cheiral points")

    # Two-view bundle adjustment (first camera frozen as gauge).
    n = len(X)
    poses = np.zeros((2, 6))
    poses[1, :3] = lie.so3_log(torch.as_tensor(R)).numpy()
    poses[1, 3:] = t
    intr_true = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    intr0 = intr_true.copy()
    intr_free = None
    if args.self_calibrate:
        intr0 = intr_true * np.array([1.05, 1.05, 0.97, 1.03])
        intr_free = torch.ones(4, dtype=torch.bool, device=dev)
        print(f"perturbed intrinsics: {intr0}")
    # Monocular two-view gauge: pose 0 fixed + the largest translation
    # component of pose 1 (7th dof).
    pf = np.zeros((2, 6), bool)
    pf[0] = True
    pf[1, 3 + int(np.argmax(np.abs(poses[1, 3:])))] = True
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    prob = BAProblem(
        poses=torch.as_tensor(poses, **f32),
        points=torch.as_tensor(X, **f32),
        intrinsics=torch.as_tensor(intr0, **f32),
        cam_idx=torch.cat([torch.zeros_like(idx), torch.ones_like(idx)]),
        pt_idx=torch.cat([idx, idx]),
        uv=torch.as_tensor(np.concatenate([ua, ub]), **f32),
        obs_mask=torch.ones(2 * n, dtype=torch.bool, device=dev),
        pose_fixed=torch.as_tensor(pf, device=dev),
        point_fixed=torch.zeros(n, dtype=torch.bool, device=dev),
        intr_free=intr_free,
    )
    ba_out, info = bundle_adjust(prob, BAOptions(max_iters=60))
    rms0 = float(np.sqrt(2 * float(info["initial_cost"]) / (2 * n)))
    rms1 = float(np.sqrt(2 * float(info["final_cost"]) / (2 * n)))
    print(f"BA reprojection RMS: {rms0:.3f} -> {rms1:.3f} px")
    out.update(points=n, rms0=rms0, rms1=rms1)
    if args.self_calibrate:
        rec = ba_out.intrinsics.double().cpu().numpy()
        err = np.abs(rec - intr_true) / np.maximum(np.abs(intr_true), 1)
        print(f"recovered intrinsics: {rec} "
              f"(rel err {np.round(100 * err, 2)} %)")
        if args.left is None:
            print("note: the default pair is a PLANAR warp — two views of "
                  "a plane leave parts of the intrinsics unobservable "
                  "(use a real 3-D pair, or see test_ba_recovers_"
                  "intrinsics for the multi-view recovery gate)")
        out.update(intrinsics=rec)

    pc = PointCloudGenerator()
    pts = ba_out.points.double().cpu().numpy()
    pc.add_points(range(len(pts)), pts)
    ply = os.path.join(args.out, "two_view.ply")
    pc.write_ply(ply)
    print(f"wrote {ply}")
    return out


if __name__ == "__main__":
    main()
