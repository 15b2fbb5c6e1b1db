#!/usr/bin/env python
"""City-scale global SfM (BASELINE config 5) on the PyTorch / CUDA port.

Twin of ``scripts/bench_city_scale.py``: 1024+ views on a city-grid
trajectory (``torch_bench_city_scale_scene.py``: a boustrophedon street
sweep with street-level structure and proximity loop pairs) through the
whole global SfM with the keyframe / map-block partitioned BA
(``ba/partitioned.py``). With ``--mesh n`` (n > 1) the BA's blocks run on
a "block" mesh over the ``n`` ranks of this process's
``torch.distributed`` world; one card is a world of one, so the default is
no mesh. Reports the stages' wall clock and the ATE, with a comm-model
projection to 2 hosts x 4 GPUs from the H100's data-sheet rates
(``parallel/comm_model``). Writes the artifact to ``--json``.

It imports only ``sara_tpu_torch`` and numpy, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_bench_city_scale.py [--views 1024]
       [--json torch_bench_city_scale.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=384)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--ba-blocks", type=int, default=16)
    ap.add_argument("--ba-sweeps", type=int, default=3)
    ap.add_argument("--ba-iters", type=int, default=12)
    ap.add_argument("--mesh", type=int, default=1,
                    help="ranks of the BA's block mesh (> 1: the "
                    "torch.distributed world this process is in)")
    ap.add_argument("--json", default="torch_bench_city_scale.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.parallel import make_mesh
    from sara_tpu_torch.parallel.comm_model import NIC_BW, PEAK_F32_FLOPS
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse
    from torch_bench_city_scale_scene import make_city_scene, proximity_pairs

    dev = resolve_device(args.device)
    log(f"building city-grid scene: {args.views} views")
    kps, centers_gt, K = make_city_scene(args.views, args.capacity,
                                         device=dev)
    pairs = proximity_pairs(centers_gt)
    log(f"{len(pairs)} pairs ({len(pairs)/args.views:.1f}/view)")

    mesh = (make_mesh(args.mesh, axis="block", device=dev)
            if args.mesh > 1 else None)
    cfg = GlobalSfMConfig(
        rel_pose_samples=args.samples, min_pair_inliers=20,
        pair_chunk=args.chunk,
        ba_options=BAOptions(max_iters=args.ba_iters),
        ba_blocks=args.ba_blocks, ba_sweeps=args.ba_sweeps)

    t0 = time.perf_counter()
    out = run_global_sfm(kps, K, pairs=pairs, config=cfg, ba_mesh=mesh,
                         device=dev)
    total = time.perf_counter() - t0

    R, t = np.asarray(out["R"]), np.asarray(out["t"])
    centers = np.stack([-R[v].T @ t[v] for v in range(args.views)])
    err = ate_rmse(centers, centers_gt)
    log(f"total {total:.1f}s, ATE {err:.4f}, edges {out['num_edges']}, "
        f"points {len(out['points'])}")
    for k, v in out.get("stage_times", {}).items():
        log(f"  stage {k}: {v:.2f}s")

    # Comm-model projection to 2 hosts x 4 GPUs: per-sweep block compute
    # is proportional to the observations; the only cross-block traffic is
    # the O(C * 6) boundary exchange per sweep, over the hosts' NIC.
    C = args.views
    n_obs = out.get("n_obs", 0)
    per_block_flops = (n_obs / max(args.ba_blocks, 1)) * 1200.0 \
        * args.ba_iters
    exchange_bytes = C * 6 * 4 + len(out.get("points", [])) * 3 * 4
    t_comp = per_block_flops / (PEAK_F32_FLOPS * 0.02)  # 2% of the peak
    t_comm = exchange_bytes / NIC_BW
    proj_eff = t_comp / (t_comp + t_comm)
    log(f"  projection (2 hosts x 4 GPUs): per-sweep block compute "
        f"{t_comp*1e3:.2f} ms, boundary exchange {t_comm*1e3:.2f} ms "
        f"-> efficiency {proj_eff*100:.1f}%")

    artifact = {
        "config": 5,
        "views": args.views,
        "pairs": len(pairs),
        "ate": round(float(err), 4),
        "total_s": round(total, 1),
        "stage_times_s": {k: round(v, 2)
                          for k, v in out.get("stage_times", {}).items()},
        "points": int(len(out["points"])),
        "edges": int(out["num_edges"]),
        "ba_blocks": args.ba_blocks,
        "ba_sweeps": args.ba_sweeps,
        "mesh_devices": args.mesh,
        "projected_2x4_efficiency": round(proj_eff, 3),
        "note": ("one process; a block mesh only over a torch.distributed "
                 "world of --mesh ranks. The comm structure: no "
                 "cross-block traffic within a sweep, an O(C*6) boundary "
                 "exchange between sweeps"),
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)
        log(f"wrote {args.json}")
    result = {"metric": "city_scale_views_per_s",
              "value": round(args.views / total, 3),
              "unit": "views/s", "ate": round(float(err), 4)}
    print(json.dumps(result))
    return dict(artifact, **result, ba_info={
        k: float(out["ba_info"][k]) for k in ("initial_cost", "final_cost")})


if __name__ == "__main__":
    main()
