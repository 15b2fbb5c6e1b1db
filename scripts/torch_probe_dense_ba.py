"""Stage by stage, the PyTorch / CUDA port's dense-Schur BA LM iteration.

Twin of ``scripts/probe_dense_ba.py``. On ``bench_ba``'s problem
(``scripts/torch_bench_ba.py::make_problem``, float32) packed point-major
by ``pack_pt_major``, it times each piece of ``ba/dense_schur.py`` on its
own: pass A (every chunk's ``_chunk_stats``, summed: the reduced camera
system), the dense (6C x 6C) solve (``_solve_cameras``), pass B (every
chunk's ``_chunk_backsub``), the cost pass (``ptm_cost``) and one whole LM
iteration (``dense_schur_bundle_adjust``). Each is the median of 3 calls
after a warm-up call: CUDA events after a synchronize on the card, the
host clock on the CPU. :func:`compose` chains the pieces into that LM
iteration's accept / reject, whose cost must equal the solver's.

It imports only ``sara_tpu_torch``, numpy, scipy and
``scripts/torch_bench_ba.py``, and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_dense_ba.py [--cams 256] [--points 100000]
       [--obs 800000] [--device cpu]
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


def pieces(ptm, Q, opts):
    """The iteration's pieces as functions: pass A () -> (Ucat, S_pt,
    rhs_pt), the solve (Ucat, S_pt, rhs_pt) -> dc6, pass B (dc6) -> dp and
    the cost (poses, points) -> cost, at ``opts``' first lambda."""
    import torch

    from sara_tpu_torch.ba.dense_schur import (_chunk_backsub, _chunk_stats,
                                               _chunked, _solve_cameras,
                                               ptm_cost)

    C = ptm.poses.shape[0]
    dt, dev = ptm.poses.dtype, ptm.poses.device
    lam = torch.full((), opts.lambda_init, dtype=dt, device=dev)
    delta, cutoff = opts.huber_delta, opts.outlier_cutoff

    def chunks():
        return _chunked((ptm.points, ptm.cam_idx, ptm.uv, ptm.slot_mask,
                         ptm.point_fixed), Q)

    def pass_a():
        Ucat = torch.zeros((C, 42), dtype=dt, device=dev)
        S_pt = torch.zeros((6 * C, 6 * C), dtype=dt, device=dev)
        rhs_pt = torch.zeros((C, 6), dtype=dt, device=dev)
        for ch in chunks():
            u, s, rh = _chunk_stats(ptm.poses, ptm.intrinsics,
                                    ptm.pose_free, lam, ch, delta, cutoff)
            Ucat, S_pt, rhs_pt = Ucat + u, S_pt + s, rhs_pt + rh
        return Ucat, S_pt, rhs_pt

    def solve(Ucat, S_pt, rhs_pt):
        return _solve_cameras(Ucat, S_pt, rhs_pt, lam, ptm.pose_free)

    def pass_b(dc6):
        return torch.cat([_chunk_backsub(ptm.poses, ptm.intrinsics,
                                         ptm.pose_free, dc6, lam, ch, delta,
                                         cutoff) for ch in chunks()])

    def cost(poses, points):
        return ptm_cost(ptm, poses, points, delta, cutoff, Q)

    return pass_a, solve, pass_b, cost


def compose(ptm, Q, opts):
    """One LM iteration from the pieces: the step from pass A, the solve
    and pass B, accepted where it lowers the cost. Returns the iteration's
    final cost."""
    import torch

    pass_a, solve, pass_b, cost = pieces(ptm, Q, opts)
    cost0 = cost(ptm.poses, ptm.points)
    dc6 = solve(*pass_a())
    new = cost(ptm.poses + dc6, ptm.points + pass_b(dc6))
    return torch.where(new < cost0, new, cost0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--obs", type=int, default=800_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from torch_bench_ba import make_problem

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.dense_schur import (dense_schur_bundle_adjust,
                                               pack_pt_major)
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    prob = make_problem(args.cams, args.points, args.obs, device=dev)
    ptm, stats = pack_pt_major(prob)
    Q = stats["chunk"]
    print("Sp", stats["sp"], "chunk", Q, "inflation",
          round(stats["inflation"], 2), flush=True)
    opts = BAOptions(max_iters=1)
    pass_a, solve, pass_b, cost = pieces(ptm, Q, opts)
    results = {}

    def timeit(name, fn):
        out, dt, first = median_ms(fn, dev, REPS)
        print(f"{name:24s} {dt:8.1f} ms   (first call {first:.1f}s)",
              flush=True)
        results[name] = dt
        return out

    Ucat, S_pt, rhs_pt = timeit("pass A (stats scan)", pass_a)
    dc6 = timeit(f"dense solve {6 * args.cams}",
                 lambda: solve(Ucat, S_pt, rhs_pt))
    timeit("pass B (backsub)", lambda: pass_b(dc6))
    timeit("cost pass", lambda: cost(ptm.poses, ptm.points))
    _, _, info = timeit("full LM iter",
                        lambda: dense_schur_bundle_adjust(ptm, opts, Q))
    results["cost_solver"] = float(info["final_cost"])
    results["cost_composed"] = float(compose(ptm, Q, opts))
    print(f"one LM iteration's cost: solver {results['cost_solver']:.6f}, "
          f"pieces composed {results['cost_composed']:.6f}", flush=True)
    return results


if __name__ == "__main__":
    main()
