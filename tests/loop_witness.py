"""Phase "loop" of chip_smoke.py through one package, for a witness of
where each package's float32 loop VO ends on the same frames.

    JAX_PLATFORMS=cpu python tests/loop_witness.py --package jax --jitter 0
    python tests/loop_witness.py --package torch --device cpu --h fused \\
        --jitter -2 -1 0 1 2
    python tests/loop_witness.py --package torch --device cuda --h rounded \\
        --jitter -2 -1 0 1 2

Both packages render chip_smoke.py's 100 frames (``vo_frames``: the
circular loop of scripts/eval_vo.py through
``tests/render3d.py::make_room(seed=1)`` at 240x320) and run them through
``OdometryPipeline.process_frame`` with eval_vo's configuration
(``chip_smoke.vo_config``: the port takes the kernel sampler, the
reference its default bilinear gather, the same function on the CPU), a
``LoopCloser`` (min_gap 25, 40 inliers, 300 hypotheses) fed by the
``on_accept`` hook, then ``closer.close(pipe, accepted - 1)``, as
``chip_smoke.phase_loop`` does.

For each ``k`` of ``--jitter`` the run scales ``BAOptions.lambda_init``
by 1 + k * 1e-6 (a few ulps, to show how far the trajectory moves with
the rounding of one LM step) and prints one JSON line: accepted frames,
ATE before and after closure, the loop edges, and the initial and final
cost of every bundle adjustment the pipeline ran.

``--h`` picks how the port's float32 dense BA forms H = V^-1 D:
``fused`` is the package as it stands (the float32 sum of the products of
the bfloat16 V^-1 and D, rounded to bfloat16 once, as ``jax.jit`` of the
reference computes it); ``rounded`` patches in ``_chunk_stats_rounded``
below, the port's earlier op-by-op bfloat16 rounding of each product and
partial sum.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAMBDA_INIT = 1e-3      # BAOptions' default in both packages


def _chunk_stats_rounded(poses, intr, pose_free, lam, chunk_in, delta,
                         cutoff):
    """``sara_tpu_torch.ba.dense_schur._chunk_stats`` with H rounded op by
    op: each product V^-1[q,k,l] D[q,l] rounded to bfloat16 before the
    sum over l (the port's H before the repair of F6)."""
    import torch

    from sara_tpu_torch.ba import dense_schur as ds

    points_q, cam_q, uv_q, m_q, ptfix_q = chunk_in
    Q, Sp = cam_q.shape
    C = poses.shape[0]
    dt = poses.dtype
    r, Jcf, Jpf = ds._slot_residual_jac(poses, points_q, intr, cam_q, uv_q,
                                        m_q, ptfix_q, delta, cutoff)
    wd = r.dtype
    cams = torch.arange(C, dtype=cam_q.dtype, device=cam_q.device)
    E = ((cam_q[..., None] == cams) & m_q[..., None]).to(wd)
    N = Q * Sp
    Jx, Jy = Jcf[:, :6], Jcf[:, 6:]
    Px, Py = Jpf[:, :3], Jpf[:, 3:]
    rx, ry = r[:, 0], r[:, 1]
    u36 = (Jx[:, :, None] * Jx[:, None, :]
           + Jy[:, :, None] * Jy[:, None, :]).reshape(N, 36)
    jtr = Jx * rx[:, None] + Jy * ry[:, None]
    camcols = torch.cat([u36, jtr], dim=1)
    Ucat = ds._acc(E.reshape(N, C), dt).T @ ds._acc(camcols, dt)
    ff = (pose_free[:, :, None] * pose_free[:, None, :]).reshape(C, 36)
    Ucat = Ucat * torch.cat([ff, pose_free], dim=1)
    V, bp = ds._point_blocks(Px, Py, rx, ry, Q, Sp, dt)
    Vinv = ds._vinv3(V, lam, dt)
    W18 = (Px[:, :, None] * Jx[:, None, :]
           + Py[:, :, None] * Jy[:, None, :]).reshape(Q, Sp, 18)
    D = torch.bmm(ds._acc(W18, dt).transpose(1, 2),
                  ds._acc(E, dt)).to(wd)
    D = D.reshape(Q, 3, 6, C) * pose_free.T[None, None, :, :].to(wd)
    H = torch.sum(Vinv.to(wd)[:, :, :, None, None] * D[:, None, :, :, :],
                  dim=2)
    D2 = D.reshape(3 * Q, 6 * C)
    H2 = H.reshape(3 * Q, 6 * C)
    S_pt = ds._acc(H2, dt).T @ ds._acc(D2, dt)
    y = torch.einsum("qkl,ql->qk", Vinv, bp).reshape(3 * Q).to(wd)
    rhs_pt = (ds._acc(D2, dt).T @ ds._acc(y, dt)).reshape(6, C).T
    return Ucat, S_pt, rhs_pt


def _recording(bundle_adjust, costs):
    """``bundle_adjust`` that appends each call's (initial, final) cost."""
    def run(prob, opts):
        out, info = bundle_adjust(prob, opts)
        costs.append([float(info["initial_cost"]), float(info["final_cost"])])
        return out, info
    return run


def _jax_pipeline(K, n_frames, scale):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sara_tpu.ba import BAOptions
    from sara_tpu.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu.sfm import odometry
    from sara_tpu.sfm.loop_closure import LoopCloser, LoopClosureConfig

    cfg = OdometryConfig(
        rel_pose_samples=300, pnp_samples=300, rel_pose_min_inliers=40,
        pnp_min_inliers=15, ba_window=8, full_ba_every=8, frontend_batch=4,
        ba_options=BAOptions(max_iters=20, lambda_init=LAMBDA_INIT * scale))
    pipe = OdometryPipeline(K, cfg)
    closer = LoopCloser(K, LoopClosureConfig(
        min_gap=max(n_frames // 4, 15), min_inliers=40,
        rel_pose_samples=300))
    return pipe, closer, odometry, (lambda im: jax.numpy.asarray(im))


def _torch_pipeline(K, n_frames, scale, device):
    import dataclasses

    import chip_smoke as cs
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm import OdometryPipeline
    from sara_tpu_torch.sfm import loop_closure as lc
    from sara_tpu_torch.sfm import odometry

    cfg = dataclasses.replace(cs.vo_config(), ba_options=BAOptions(
        max_iters=20, lambda_init=LAMBDA_INIT * scale))
    pipe = OdometryPipeline(K, cfg, device=device)
    closer = lc.LoopCloser(K, lc.LoopClosureConfig(
        min_gap=max(n_frames // 4, 15), min_inliers=40,
        rel_pose_samples=300), device=device)
    return pipe, closer, odometry, (lambda im: im)


def run_once(args, K, imgs, centers, k):
    scale = 1.0 + k * 1e-6
    if args.package == "jax":
        pipe, closer, odometry, put = _jax_pipeline(K, len(imgs), scale)
    else:
        pipe, closer, odometry, put = _torch_pipeline(K, len(imgs), scale,
                                                      args.device)
    from sara_tpu_torch.utils import ate_rmse

    costs = []
    bundle_adjust = odometry.bundle_adjust
    odometry.bundle_adjust = _recording(bundle_adjust, costs)
    pipe.on_accept = lambda kp, vid: closer.add_frame(kp)
    t0 = time.perf_counter()
    try:
        ok = [bool(pipe.process_frame(put(im), f))
              for f, im in enumerate(imgs)]
        accepted = int(sum(ok))
        gt = centers[np.flatnonzero(ok)]
        ate_before = float(ate_rmse(pipe.trajectory(), gt))
        closed = bool(closer.close(pipe, accepted - 1))
        ate_after = float(ate_rmse(pipe.trajectory(), gt))
    finally:
        odometry.bundle_adjust = bundle_adjust
    return {
        "package": args.package, "device": args.device,
        "h": args.h if args.package == "torch" else "jit",
        "k": k, "lambda_init": LAMBDA_INIT * scale,
        "frames": len(imgs), "accepted": accepted,
        "ate_before": ate_before, "ate_after": ate_after, "closed": closed,
        "loop_edges": [{"a": int(a), "b": int(b), "inliers": int(n),
                        "kind": "metric" if metric else "E-only"}
                       for (a, b, _R, _t, n, metric, _d)
                       in closer.loop_edges],
        "ba_costs": costs, "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the reference runs on the CPU)")
    ap.add_argument("--h", choices=("fused", "rounded"), default="fused",
                    help="the port's H = V^-1 D: as the package forms it, or "
                    "rounded op by op (the port before F6's repair)")
    ap.add_argument("--jitter", type=int, nargs="+", default=[0],
                    help="k of each run: lambda_init x (1 + k * 1e-6)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--threads", type=int, default=2,
                    help="torch intra-op threads on the CPU")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs

    if args.package == "jax":
        args.device = "cpu"
    elif torch.device(args.device).type == "cpu":
        torch.set_num_threads(args.threads)
    if args.package == "torch" and args.h == "rounded":
        from sara_tpu_torch.ba import dense_schur as ds
        ds._chunk_stats = _chunk_stats_rounded
    K, imgs, centers = cs.vo_frames(args.frames, cs.LOOP_HW,
                                    loop=args.frames)
    for k in args.jitter:
        print(json.dumps(run_once(args, K, imgs, centers, k)), flush=True)


if __name__ == "__main__":
    main()
