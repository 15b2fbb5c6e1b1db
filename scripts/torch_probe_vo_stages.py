"""Per-stage VO timing of the PyTorch / CUDA port.

Twin of ``scripts/probe_vo_stages.py``. Isolates, on two renders of
``tests/render3d.py::make_room(seed=1)``: the SIFT frontend at the
odometry's configuration, descriptor matching, E-RANSAC (the 5-point
estimator), PnP RANSAC on 512 synthetic points and linear triangulation.
Each stage is the median of 5 calls after a warm-up call: CUDA events
after a synchronize on the card, the host clock on the CPU. The probe
renders at 240x320 whatever ``--hw`` says; the twin renders at ``--hw``.

It imports only ``sara_tpu_torch``, numpy and ``tests/render3d.py``, and
runs on the card unless ``--device cpu`` is given; without a card it
raises.

Usage: python scripts/torch_probe_vo_stages.py [--device cpu] [--hw 240x320]
       [--samples 300]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

REPS = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", default="240x320")
    ap.add_argument("--samples", type=int, default=300)
    args = ap.parse_args(argv)

    import torch
    from render3d import make_room, render

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.mvg import triangulate_linear
    from sara_tpu_torch.ransac import (estimate_absolute_pose,
                                       estimate_relative_pose)
    from sara_tpu_torch.sfm.odometry import OdometryConfig
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    h, w = map(int, args.hw.split("x"))
    K = np.array([[0.8 * w, 0, w / 2.0], [0, 0.8 * w, h / 2.0], [0, 0, 1.0]])
    planes = make_room(seed=1)
    imgs = [torch.as_tensor(render(planes, K, np.eye(3),
                                   np.array([0.05 * i, 0, 0.1 * i]),
                                   hw=(h, w))).to(dev)
            for i in range(2)]
    sp = OdometryConfig().sift
    out = {}

    def timeit(fn):
        return median_ms(fn, dev, REPS)[1]

    kp0 = compute_sift_keypoints(imgs[0], sp, device=dev)
    kp1 = compute_sift_keypoints(imgs[1], sp, device=dev)
    out["SIFT frontend"] = timeit(
        lambda: compute_sift_keypoints(imgs[1], sp, device=dev))
    print(f"SIFT frontend: {out['SIFT frontend']:.1f} ms "
          f"({int(kp1.count())} kp)", flush=True)

    mp = MatchParams(ratio=0.8)
    m = match_descriptors(kp0, kp1, mp, device=dev)
    out["matching"] = timeit(lambda: match_descriptors(kp0, kp1, mp,
                                                       device=dev))
    print(f"matching: {out['matching']:.1f} ms ({int(m.count())})",
          flush=True)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    v = kp1.xy[m.j.long()]

    def erans():
        res, R, t = estimate_relative_pose(
            gen(), kp0.xy, v, m.mask, Kt, Kt, threshold_px=4.0,
            num_samples=args.samples, min_inliers=40)
        return res.inliers.sum()

    out["E-RANSAC"] = timeit(erans)
    print(f"E-RANSAC ({args.samples} samples): {out['E-RANSAC']:.1f} ms",
          flush=True)

    # PnP on synthetic 3-D points.
    rs = np.random.RandomState(0)
    P = 512
    X = rs.uniform(-2, 2, (P, 3)) + np.array([0, 0, 6.0])
    uvp = X @ K.T
    uvp = uvp[:, :2] / uvp[:, 2:]
    rays = np.concatenate([uvp, np.ones((P, 1))], axis=1) @ np.linalg.inv(K).T
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Xt, rt, uvt = f32(X), f32(rays), f32(uvp)
    mask = torch.ones(P, dtype=torch.bool, device=dev)

    def pnp():
        res, R, t = estimate_absolute_pose(
            gen(), Xt, rt, uvt, Kt, mask, threshold_px=5.0,
            num_samples=args.samples, min_inliers=20)
        return res.inliers.sum()

    out["PnP RANSAC"] = timeit(pnp)
    print(f"PnP RANSAC ({args.samples} samples): {out['PnP RANSAC']:.1f} ms",
          flush=True)

    R = f32(np.eye(3))
    t = f32([0.5, 0.0, 0.0])

    def tri():
        X3, d1, d2 = triangulate_linear(R, t, rt, rt)
        return X3.sum()

    out["triangulation"] = timeit(tri)
    print(f"triangulation ({P} rays): {out['triangulation']:.1f} ms",
          flush=True)
    return out


if __name__ == "__main__":
    main()
