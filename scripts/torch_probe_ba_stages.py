"""Where the PyTorch / CUDA port's BA LM iteration spends its time.

Twin of ``scripts/probe_ba_stages.py``. On the probe's problem (C cameras
along the x axis, P points, O observations sorted by camera, 0.5 px noise,
float32) it times each piece of ``ba/core.py`` on its own: the cost, the
closed-form and the autodiff Jacobians, the block assembly (``index_add_``
segment sums), the 3x3 and 6x6 block inverses, one and ``--cg`` Schur
matvecs, one damped solve (``_solve_lm``) and one whole LM iteration of
``bundle_adjust`` (which takes the dense-Schur solver where it is
eligible, as the reference's does). Each is the median of 3 calls after a
warm-up call: CUDA events after a synchronize on the card, the host clock
on the CPU.

It imports only ``sara_tpu_torch`` and numpy, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_ba_stages.py [--cams 256] [--points 60000]
       [--obs 800000] [--cg 15] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

REPS = 3


def make_problem(C, P, O, device, seed=0):
    """The probe's problem: points in front of C translated cameras, O
    observations sorted by camera, 0.5 px noise, camera 0 fixed."""
    import torch

    from sara_tpu_torch.ba import BAProblem

    rs = np.random.RandomState(seed)
    X = rs.uniform(-10, 10, (P, 3)) + np.array([0, 0, 30.0])
    poses = np.zeros((C, 6))
    poses[:, 3] = np.linspace(0, 10, C)
    intr = np.array([800.0, 800.0, 512.0, 384.0])
    cam_idx = np.sort(rs.randint(0, C, O)).astype(np.int32)
    pt_idx = rs.randint(0, P, O).astype(np.int32)
    Xc = X[pt_idx] + poses[cam_idx][:, 3:]
    uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                   intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], axis=1)
    uv += rs.normal(scale=0.5, size=uv.shape)
    pose_fixed = np.zeros(C, bool)
    pose_fixed[0] = True

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def on(a):
        return torch.as_tensor(a, device=device)

    return BAProblem(poses=f32(poses), points=f32(X), intrinsics=f32(intr),
                     cam_idx=on(cam_idx), pt_idx=on(pt_idx), uv=f32(uv),
                     obs_mask=on(np.ones(O, bool)),
                     pose_fixed=on(pose_fixed),
                     point_fixed=on(np.zeros(P, bool)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--obs", type=int, default=800000)
    ap.add_argument("--cg", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import bundle_adjust
    from sara_tpu_torch.ba.core import (BAOptions, _damp,
                                        _gauss_newton_blocks, _jacobians,
                                        _jacobians_closed_form,
                                        _schur_matvec, _solve_lm, ba_cost)
    from sara_tpu_torch.ops.smallmat import batched_inv
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    C, P = args.cams, args.points
    prob = make_problem(C, P, args.obs, dev)
    opts = BAOptions(max_iters=1, cg_iters=args.cg)
    results = {}

    def timeit(name, fn):
        out, dt, first = median_ms(fn, dev, REPS)
        print(f"{name:24s} {dt:8.1f} ms   (first call {first:.1f}s)",
              flush=True)
        results[name] = dt
        return out

    timeit("cost", lambda: ba_cost(prob, 4.0))
    timeit("jacobians_closed", lambda: _jacobians_closed_form(prob, 4.0, 6.0))
    r, Jc, Jp, _ = timeit("jacobians", lambda: _jacobians(prob, 4.0, 6.0))
    U, V, Wo, bc, bp = timeit("gn_blocks(segsum)",
                              lambda: _gauss_newton_blocks(prob, r, Jc, Jp))
    Vinv = timeit("inv_blocks(V 3x3)", lambda: batched_inv(_damp(V, 1e-3)))
    timeit("inv_blocks(U 6x6)", lambda: batched_inv(_damp(U, 1e-3)))

    U_d = _damp(U, 1e-3)
    cam_idx, pt_idx = prob.cam_idx.long(), prob.pt_idx.long()

    def matvec(x):
        return _schur_matvec(x, U_d, Vinv, Wo, cam_idx, pt_idx, C, P)

    x0 = torch.ones((C, 6), dtype=torch.float32, device=dev)
    timeit("schur_matvec x1", lambda: matvec(x0))

    def matvecs():
        x = x0
        for _ in range(args.cg):
            x = matvec(x) * 1e-3
        return x

    timeit(f"schur_matvec x{args.cg}", matvecs)
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    timeit("solve_lm(full)", lambda: _solve_lm(prob, r, Jc, Jp, None, lam,
                                               opts))
    timeit("LM iter (full step)", lambda: bundle_adjust(prob, opts))
    return results


if __name__ == "__main__":
    main()
