"""Same-process ablation of the stratified dense-Schur LM iteration of the
PyTorch / CUDA port.

Twin of ``scripts/probe_dense_ablate.py``. On ``bench_ba``'s problem
(``scripts/torch_bench_ba.py::make_problem``, float32) packed into
point-major strata by ``pack_pt_major_strata``, each variant runs over
the whole stratified problem and is timed on its own:

- ``passA-jac``: per chunk the slot residuals and Jacobians, the camera
  columns' contraction (Ucat), the point blocks V, bp, V^-1 and the W
  blocks (no D, H or S);
- ``passA-noS``: pass A without the S contraction (D, H and the right-hand
  side kept);
- ``passA-full``: pass A as the solver runs it (``ba/dense_schur.py::
  _chunk_stats``);
- ``cost``: the cost of every stratum (``ptm_cost``);
- ``passB``: the back-substitution of every chunk (``_chunk_backsub``) of
  a zero camera step;
- ``solve``: the dense (6C x 6C) camera solve (``_solve_cameras``);
- ``full LM iter``: one iteration of ``dense_schur_bundle_adjust_strata``.

Each is the median of 3 calls after a warm-up call (CUDA events after a
synchronize on the card, the host clock on the CPU). :func:`compose`
chains pass A, the solve, pass B and the cost into the iteration's accept
/ reject, whose cost must equal the solver's.

It imports only ``sara_tpu_torch``, numpy, scipy and
``scripts/torch_bench_ba.py``, and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_dense_ablate.py [--cams 256]
       [--points 100000] [--obs 800000] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

REPS = 3
MODES = ("jac", "noS", "full")


def _stats(mode, poses, intr, pose_free, lam, chunk_in, delta, cutoff):
    """One chunk of pass A cut at ``mode`` ("jac", "noS"; "full" is the
    solver's ``_chunk_stats``): (Ucat, S_pt, rhs_pt) contributions, the
    parts a mode leaves out are zero."""
    import torch

    from sara_tpu_torch.ba.dense_schur import (_acc, _chunk_stats,
                                               _point_blocks,
                                               _slot_residual_jac, _vinv3)

    if mode == "full":
        return _chunk_stats(poses, intr, pose_free, lam, chunk_in, delta,
                            cutoff)
    points_q, cam_q, uv_q, m_q, ptfix_q = chunk_in
    Q, Sp = cam_q.shape
    C = poses.shape[0]
    dt = poses.dtype
    r, Jcf, Jpf = _slot_residual_jac(poses, points_q, intr, cam_q, uv_q,
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
    Ucat = _acc(E.reshape(N, C), dt).T @ _acc(camcols, dt)
    ff = (pose_free[:, :, None] * pose_free[:, None, :]).reshape(C, 36)
    Ucat = Ucat * torch.cat([ff, pose_free], dim=1)
    V, bp = _point_blocks(Px, Py, rx, ry, Q, Sp, dt)
    Vinv = _vinv3(V, lam, dt)
    W18 = (Px[:, :, None] * Jx[:, None, :]
           + Py[:, :, None] * Jy[:, None, :]).reshape(Q, Sp, 18)
    S_pt = torch.zeros((6 * C, 6 * C), dtype=dt, device=poses.device)
    rhs_pt = torch.zeros((C, 6), dtype=dt, device=poses.device)
    if mode == "jac":
        return Ucat, S_pt, rhs_pt
    D = torch.bmm(_acc(W18, dt).transpose(1, 2), _acc(E, dt)).to(wd)
    D = D.reshape(Q, 3, 6, C) * pose_free.T[None, None, :, :].to(wd)
    # H = V^-1 D as the solver forms it; only the S contraction that
    # would read it is left out (eager: nothing computed is dropped).
    torch.sum(_acc(Vinv.to(wd), dt)[:, :, :, None, None]
              * _acc(D, dt)[:, None, :, :, :], dim=2).to(wd)
    D2 = D.reshape(3 * Q, 6 * C)
    y = torch.einsum("qkl,ql->qk", Vinv, bp).reshape(3 * Q).to(wd)
    rhs_pt = (_acc(D2, dt).T @ _acc(y, dt)).reshape(6, C).T
    return Ucat, S_pt, rhs_pt


def pieces(strata, Qs, opts):
    """The iteration's pieces over every stratum, at ``opts``' first
    lambda: pass A (mode) -> (Ucat, S_pt, rhs_pt), the cost (poses,
    points per stratum) -> cost, pass B (dc6) -> dp per stratum and the
    solve (Ucat, S_pt, rhs_pt) -> dc6."""
    import torch

    from sara_tpu_torch.ba.dense_schur import (_chunk_backsub, _chunked,
                                               _solve_cameras, ptm_cost)

    p0 = strata[0]
    C = p0.poses.shape[0]
    dt, dev = p0.poses.dtype, p0.poses.device
    lam = torch.full((), opts.lambda_init, dtype=dt, device=dev)
    delta, cutoff = opts.huber_delta, opts.outlier_cutoff

    def chunks(ptm, Q):
        return _chunked((ptm.points, ptm.cam_idx, ptm.uv, ptm.slot_mask,
                         ptm.point_fixed), Q)

    def pass_a(mode):
        Ucat = torch.zeros((C, 42), dtype=dt, device=dev)
        S_pt = torch.zeros((6 * C, 6 * C), dtype=dt, device=dev)
        rhs_pt = torch.zeros((C, 6), dtype=dt, device=dev)
        for ptm, Q in zip(strata, Qs):
            for ch in chunks(ptm, Q):
                u, s, rh = _stats(mode, p0.poses, ptm.intrinsics,
                                  ptm.pose_free, lam, ch, delta, cutoff)
                Ucat, S_pt, rhs_pt = Ucat + u, S_pt + s, rhs_pt + rh
        return Ucat, S_pt, rhs_pt

    def cost(poses, points_t):
        c = poses.new_zeros(())
        for ptm, pts, Q in zip(strata, points_t, Qs):
            c = c + ptm_cost(ptm, poses, pts, delta, cutoff, Q)
        return c

    def pass_b(dc6):
        return [torch.cat([_chunk_backsub(p0.poses, ptm.intrinsics,
                                          ptm.pose_free, dc6, lam, ch,
                                          delta, cutoff)
                           for ch in chunks(ptm, Q)])
                for ptm, Q in zip(strata, Qs)]

    def solve(Ucat, S_pt, rhs_pt):
        return _solve_cameras(Ucat, S_pt, rhs_pt, lam, p0.pose_free)

    return pass_a, cost, pass_b, solve


def compose(strata, Qs, opts):
    """One LM iteration from the pieces: the step from pass A ("full"),
    the solve and pass B, accepted where it lowers the cost. Returns the
    iteration's final cost."""
    import torch

    pass_a, cost, pass_b, solve = pieces(strata, Qs, opts)
    poses = strata[0].poses
    points = [ptm.points for ptm in strata]
    cost0 = cost(poses, points)
    dc6 = solve(*pass_a("full"))
    new = cost(poses + dc6, [p + dp for p, dp in zip(points,
                                                     pass_b(dc6))])
    return torch.where(new < cost0, new, cost0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--obs", type=int, default=800_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from torch_bench_ba import make_problem

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.dense_schur import (
        dense_schur_bundle_adjust_strata, pack_pt_major_strata)
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    prob = make_problem(args.cams, args.points, args.obs, device=dev)
    strata, _, stats = pack_pt_major_strata(prob)
    Qs = tuple(stats["chunks"])
    print("sps", stats["sps"], "chunks", stats["chunks"],
          "inflation", round(stats["inflation"], 2), flush=True)
    opts = BAOptions(max_iters=1)
    pass_a, cost, pass_b, solve = pieces(strata, Qs, opts)
    poses = strata[0].poses
    points = [ptm.points for ptm in strata]
    results = {}

    def timeit(name, fn):
        out, dt, first = median_ms(fn, dev, REPS)
        print(f"{name:12s} {dt:8.1f} ms   (first call {first:.1f}s)",
              flush=True)
        results[name] = dt
        return out

    acc = {}
    for mode in MODES:
        acc[mode] = timeit(f"passA-{mode}", lambda m=mode: pass_a(m))
    timeit("cost", lambda: cost(poses, points))
    zero = torch.zeros((args.cams, 6), dtype=poses.dtype, device=dev)
    timeit("passB", lambda: pass_b(zero))
    timeit("solve", lambda: solve(*acc["full"]))
    _, _, info = timeit("full LM iter", lambda:
                        dense_schur_bundle_adjust_strata(tuple(strata), opts,
                                                         Qs))
    results["cost_solver"] = float(info["final_cost"])
    results["cost_composed"] = float(compose(strata, Qs, opts))
    print(f"one LM iteration's cost: solver {results['cost_solver']:.6f}, "
          f"pieces composed {results['cost_composed']:.6f}", flush=True)
    return results


if __name__ == "__main__":
    main()
