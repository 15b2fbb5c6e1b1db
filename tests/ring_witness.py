"""Config 4's ring scene through one package on the CPU, for a witness of
both packages at the same size and seed.

    python tests/ring_witness.py --package jax   --views 500
    python tests/ring_witness.py --package torch --views 500

Both runs build scripts/bench_sfm_scale.py's ring scene (900 points,
capacity 512, 0.3 px noise, seed 1), pair each view with the next
``--window`` views and run ``run_global_sfm`` with bench_sfm_scale's
configuration (256 hypotheses, 20 inliers, chunks of 32, 40 BA
iterations). The JAX run is bench_sfm_scale's own scene and call; the
port's is ``chip_smoke.phase_global_sfm``'s. Each prints one JSON line: the
ATE after averaging, after the polish and at the end, the edge count, the
edges whose relative rotation / translation direction is off by more than
1 degree (with their median and maximum), and the seconds of each stage.
The port runs on one torch thread (the CPU's batched ``solve_ex`` trap).
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


def run_jax(views, points, capacity, window):
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from bench_sfm_scale import _make_ring_scene

    from sara_tpu.ba import BAOptions
    from sara_tpu.sfm.global_sfm import GlobalSfMConfig, run_global_sfm

    kps, centers_gt, K = _make_ring_scene(views, points, capacity)
    pairs = [(i, j) for i in range(views)
             for j in range(i + 1, min(i + 1 + window, views))]
    cfg = GlobalSfMConfig(rel_pose_samples=256, min_pair_inliers=20,
                          pair_chunk=32, ba_options=BAOptions(max_iters=40))
    return run_global_sfm(kps, K, pairs=pairs, config=cfg), centers_gt, pairs


def run_torch(views, points, capacity, window):
    import torch

    torch.set_num_threads(1)
    import chip_smoke as cs
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm import global_sfm as gs

    kps, centers_gt, K = cs.make_ring_scene(views, points, capacity,
                                            device="cpu")
    pairs = [(i, j) for i in range(views)
             for j in range(i + 1, min(i + 1 + window, views))]
    cfg = gs.GlobalSfMConfig(rel_pose_samples=256, min_pair_inliers=20,
                             pair_chunk=32,
                             ba_options=BAOptions(max_iters=40))
    return (gs.run_global_sfm(kps, K, pairs=pairs, config=cfg, device="cpu"),
            centers_gt, pairs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--views", type=int, default=500)
    ap.add_argument("--points", type=int, default=900)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--window", type=int, default=4)
    args = ap.parse_args()
    run = run_jax if args.package == "jax" else run_torch
    t0 = time.perf_counter()
    res, centers_gt, pairs = run(args.views, args.points, args.capacity,
                                 args.window)
    total = time.perf_counter() - t0

    import chip_smoke as cs

    def ate(c):
        # utils.metrics.ate_rmse of both packages: similarity-aligned RMSE.
        from sara_tpu_torch.utils import ate_rmse
        return float(ate_rmse(np.asarray(c), centers_gt))

    R, t = np.asarray(res["R"]), np.asarray(res["t"])
    centers = np.stack([-R[v].T @ t[v] for v in range(args.views)])
    edges = [tuple(int(i) for i in e) for e in res["edges"]]
    err = cs.edge_errors_deg(edges, [np.asarray(r) for r in res["edge_R"]],
                             [np.asarray(x) for x in res["edge_t"]],
                             cs.ring_rotations(args.views), centers_gt)
    print(json.dumps({
        "package": args.package, "views": args.views, "pairs": len(pairs),
        "edges": len(edges), "points": int(len(res["points"])),
        "ate": ate(centers), "ate_averaged": ate(res["centers_averaged"]),
        "ate_polished": ate(res["centers_polished"]),
        "rot_err_deg_median_max_over1": err["rot"],
        "dir_err_deg_median_max_over1": err["dir"],
        "missing_pairs": sorted(set(pairs) - set(edges))[:40],
        "stage_s": {k: float(v) for k, v in res["stage_times"].items()},
        "total_s": total}), flush=True)


if __name__ == "__main__":
    main()
