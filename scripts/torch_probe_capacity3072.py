"""The first_octave = -1 SIFT program at the default capacity, the
two-frame match and one relative pose, on the PyTorch / CUDA port.

Twin of ``scripts/probe_capacity3072.py``. The probe checked on the TPU a
configuration that once faulted its worker (capacities >= 3072); on the
card the same program must simply run. In order:

- frame A through ``compute_sift_keypoints(SIFTParams())`` (the first call,
  its seconds), then frame B;
- ``match_descriptors`` (ratio 0.8) of A against B;
- a warm re-time of frame A (the mean of 3 calls, each ended by reading
  the keypoint count, as the probe's);
- ``estimate_relative_pose`` on the probe's synthetic scene (300 points
  5 units ahead, a 0.5 unit shift along x, threshold 0.01, identity
  intrinsics, 50 inliers required, generator seeded 0), held to the
  probe's own assert: inliers > 0.9 n, R error < 0.5 deg, t error < 1.0
  deg.

The frames are ``torch_bench.probe_frames(2)`` (the reference's two
photographs, else two renders of ``make_room(seed=1)``), printed. It
imports only ``sara_tpu_torch``, numpy and ``torch_bench``, and runs on
the card unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_capacity3072.py [--hw 480x640]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def synthetic_scene(n=300):
    """The probe's scene: (u, v) normalized projections of n points seen
    from the origin and after a 0.5 shift along x, and the true (R, t)."""
    rs = np.random.RandomState(0)
    X = rs.randn(n, 3) + np.array([0, 0, 5.0])
    R_gt = np.eye(3)
    t_gt = np.array([0.5, 0.0, 0.0])
    u = X[:, :2] / X[:, 2:]
    X2 = X @ R_gt.T + t_gt
    v = X2[:, :2] / X2[:, 2:]
    return u, v, R_gt, t_gt


def relative_pose(dev, n=300) -> dict:
    """The probe's relative pose on :func:`synthetic_scene` on ``dev``:
    inliers, rotation and direction errors in degrees."""
    import torch

    from sara_tpu_torch.ransac.estimators import estimate_relative_pose

    u, v, R_gt, t_gt = synthetic_scene(n)
    f32 = dict(dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    eye = torch.eye(3, **f32)
    res, R, t = estimate_relative_pose(
        gen, torch.as_tensor(u, **f32), torch.as_tensor(v, **f32),
        torch.ones((n,), dtype=torch.bool, device=dev), eye, eye,
        threshold_px=0.01, min_inliers=50)
    t_est = t.cpu().double().numpy()
    t_est = t_est / np.linalg.norm(t_est)
    terr = np.degrees(np.arccos(np.clip(abs(np.dot(
        t_est, t_gt / np.linalg.norm(t_gt))), -1, 1)))
    rerr = np.degrees(np.arccos(np.clip(
        (np.trace(R.cpu().double().numpy().T @ R_gt) - 1) / 2, -1, 1)))
    return {"inliers": int(res.num_inliers), "n": n, "rerr": float(rerr),
            "terr": float(terr)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import torch_bench
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.matching import MatchParams, match_descriptors

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    (a, b), source = torch_bench.probe_frames(2, h, w)
    print("device:", dev, "input:", source, flush=True)
    a, b = (torch.as_tensor(x).to(dev) for x in (a, b))
    params = SIFTParams()
    print("capacity:", params.dog.capacity, "total:", params.total_capacity,
          flush=True)
    out = {}
    t0 = time.perf_counter()
    ka = compute_sift_keypoints(a, params, device=dev)
    out["n_a"] = int(ka.count())
    print(f"frame A: {out['n_a']} kp  ({time.perf_counter() - t0:.1f}s "
          "incl first call)", flush=True)
    t0 = time.perf_counter()
    kb = compute_sift_keypoints(b, params, device=dev)
    out["n_b"] = int(kb.count())
    print(f"frame B: {out['n_b']} kp  ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    out["matches"] = int(m.count())
    print("matches:", out["matches"], flush=True)

    t0 = time.perf_counter()
    for _ in range(3):
        ka = compute_sift_keypoints(a, params, device=dev)
        int(ka.count())
    out["warm_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"single-frame warm: {out['warm_ms']:.0f} ms", flush=True)

    rp = relative_pose(dev)
    out.update(rp)
    print(f"relative pose: inliers {rp['inliers']}/{rp['n']}, "
          f"Rerr {rp['rerr']:.3f} deg, terr {rp['terr']:.3f} deg",
          flush=True)
    assert rp["inliers"] > 0.9 * rp["n"] and rp["rerr"] < 0.5 \
        and rp["terr"] < 1.0, rp
    print("OK", flush=True)
    return out


if __name__ == "__main__":
    main()
