"""Global (unordered) SfM demo on the PyTorch / CUDA port: rendered
multi-view scene -> SIFT -> pairwise matching + E-RANSAC ->
rotation/translation averaging -> multi-view triangulation -> global bundle
adjustment -> PLY export.

Twin of ``examples/global_sfm_demo.py``. It imports only ``sara_tpu_torch``
(and the NumPy renderer ``tests/render3d.py``, as the JAX demo does) and
runs on the card unless ``--cpu`` is given; without a card it raises. The
pair stage runs as chunks of batched match + RANSAC programs.

Usage: python examples/torch_global_sfm_demo.py [--views 8] [--out dir]
                                                [--cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sara_tpu_torch_global_sfm"))
    ap.add_argument("--pair-chunk", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from render3d import make_room, render
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.features.dog import DoGParams
    from sara_tpu_torch.image.pyramid import PyramidParams
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.sfm.pointcloud import write_ply
    from sara_tpu_torch.utils import ate_rmse

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    planes = make_room(seed=1)

    # Camera ring through the rendered room.
    imgs, centers = [], []
    for i in range(args.views):
        ang = 0.03 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([0.2 * i, 0.0, 0.25 * i])
        imgs.append(render(planes, K, R, -R @ c))
        centers.append(c)
    centers = np.asarray(centers)

    t0 = time.perf_counter()
    # Pipeline detector config (first_octave=0), like the reference SfM
    # FeatureParams.
    params = SIFTParams(pyramid=PyramidParams(first_octave=0),
                        dog=DoGParams(capacity=1024), total_capacity=4096)
    kps = [compute_sift_keypoints(im, params, device=dev) for im in imgs]
    counts = [int(k.count()) for k in kps]
    print(f"SIFT on {args.views} views: {counts} keypoints "
          f"({time.perf_counter()-t0:.1f}s, first call)")

    t0 = time.perf_counter()
    cfg = GlobalSfMConfig(rel_pose_samples=500, min_pair_inliers=30,
                          pair_chunk=args.pair_chunk)
    out = run_global_sfm(kps, K, config=cfg, device=dev)
    print(f"global SfM: {out['num_edges']} verified pairs, "
          f"{len(out['points'])} points "
          f"({time.perf_counter()-t0:.1f}s)")

    est_centers = np.stack([-out["R"][v].T @ out["t"][v]
                            for v in range(args.views)])
    ate = ate_rmse(est_centers, centers)
    print(f"ATE vs ground truth: {ate:.4f}")

    ply = os.path.join(args.out, "cloud.ply")
    write_ply(ply, out["points"])
    print(f"wrote {ply}")
    # The BA's problem as triangulation handed it over, its info and the
    # true centres, for checks of the float32 solve against another.
    return dict(keypoints=counts, edges=int(out["num_edges"]),
                points=len(out["points"]), ate=float(ate),
                ba_problem=out["ba_problem"], ba_info=out["ba_info"],
                centers=centers)


if __name__ == "__main__":
    main()
