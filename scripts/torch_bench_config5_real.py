#!/usr/bin/env python
"""BASELINE config 5 with the real frontend on the PyTorch / CUDA port.

Twin of ``scripts/bench_config5_real.py``: V >= 128 views of the textured
room (``torch_eval_real_images.make_real_room``: the reference's
photographs, or ``make_room(seed=1)``'s procedural textures where they are
missing) on a circular loop through the whole pipeline with no planted
descriptors: SIFT detection and description (the SfM's first_octave=0
parameters, the kernel sampler: ``ops/patch_sampler.py``'s CUDA kernel on
the card) -> circular-window pair matching + E-RANSAC -> rotation
averaging -> edge scales -> triangulation -> the keyframe / map-block
partitioned BA. Pairs come from the loop's topology only
(|i - j| mod V <= window).

The artifact holds the stages' wall clock, the ATE and a table of the
partitioned BA on the same packed problem over meshes of n ranks. A mesh
here is the ``torch.distributed`` world this process is in, so on one
card the table holds n = 1 only; larger n wait for more than one GPU.

It imports only ``sara_tpu_torch``, numpy, scipy and the numpy helpers of
``tests/``, and runs on the card unless ``--device cpu`` is given; without
a card it raises.

Usage: python scripts/torch_bench_config5_real.py [--views 128]
           [--json torch_bench_config5_real.json] [--device cpu]
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
for p in (ROOT, os.path.join(ROOT, "tests"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_config5(views=128, hw=(240, 320), window=3, capacity=1024,
                total_capacity=2048, samples=256, chunk=16, ba_blocks=8,
                ba_sweeps=3, ba_iters=10, mesh_devices=1,
                scaling=(1, 2, 4, 8), log=_log, device="cuda"):
    """The whole real-frontend config-5 run; returns the artifact dict."""
    import multiprocessing

    import torch
    import torch.distributed as dist

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.features.api import DoGParams, PyramidParams
    from sara_tpu_torch.parallel import make_mesh
    from sara_tpu_torch.parallel.comm_model import NIC_BW, PEAK_F32_FLOPS
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse
    from torch_eval_real_images import room_scene
    from torch_eval_vo import room_loop

    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    stage_t = {}
    t0 = time.perf_counter()
    log(f"rendering {views} views of the room at {hw}")
    K, imgs, centers_gt = room_loop(views, hw)
    stage_t["render"] = time.perf_counter() - t0

    # The real frontend on every view, SfM parameters (first_octave=0, as
    # the reference's FeatureParams).
    sp = SIFTParams(pyramid=PyramidParams(first_octave=0),
                    dog=DoGParams(capacity=capacity, refine_iters=2),
                    total_capacity=total_capacity, desc_sampler="kernel")
    t0 = time.perf_counter()
    kps = []
    for v, im in enumerate(imgs):
        kp = compute_sift_keypoints(im, sp, device=dev)
        if v == 0:  # the first view's one-time costs apart
            sync()
            stage_t["detect_compile"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        kps.append(kp)
    sync()
    stage_t["detect"] = time.perf_counter() - t0
    n_kp = float(np.mean([int(k.mask.sum()) for k in kps]))
    log(f"detected {n_kp:.0f} kp/view "
        f"({stage_t['detect']:.1f}s steady, "
        f"{stage_t['detect_compile']:.1f}s first)")

    # Pairs from the loop's topology only.
    pairs = sorted({tuple(sorted((i, (i + d) % views)))
                    for i in range(views) for d in range(1, window + 1)})

    mesh = (make_mesh(mesh_devices, axis="block", device=dev)
            if mesh_devices > 1 else None)
    cfg = GlobalSfMConfig(
        rel_pose_samples=samples, min_pair_inliers=20, pair_chunk=chunk,
        ba_options=BAOptions(max_iters=ba_iters),
        ba_blocks=ba_blocks, ba_sweeps=ba_sweeps)

    t0 = time.perf_counter()
    out = run_global_sfm(kps, K, pairs=pairs, config=cfg, ba_mesh=mesh,
                         device=dev)
    total_sfm = time.perf_counter() - t0
    stage_t.update({f"sfm/{k}": v for k, v in out["stage_times"].items()})

    R, t = np.asarray(out["R"]), np.asarray(out["t"])
    centers = np.stack([-R[v].T @ t[v] for v in range(views)])
    err = ate_rmse(centers, centers_gt)
    log(f"global SfM {total_sfm:.1f}s, ATE {err:.4f}, "
        f"edges {out['num_edges']}/{len(pairs)}, points {len(out['points'])}")

    # The partitioned BA on the same packed problem, on meshes of n ranks
    # of this process's world.
    prob = out["ba_problem"]
    opts = BAOptions(max_iters=ba_iters)
    world = dist.get_world_size() if dist.is_initialized() else 1
    scaling_rows = []
    base = None
    for n in scaling:
        if n > world:
            break
        m = make_mesh(n, axis="block", device=dev) if n > 1 else None
        res, info = partitioned_bundle_adjust(
            prob, ba_blocks, opts, sweeps=ba_sweeps, mesh=m)
        float(info["final_cost"])  # first call apart
        t0 = time.perf_counter()
        res, info = partitioned_bundle_adjust(
            prob, ba_blocks, opts, sweeps=ba_sweeps, mesh=m)
        final_cost = float(info["final_cost"])
        dt = time.perf_counter() - t0
        base = base or dt
        scaling_rows.append({
            "mesh_devices": n, "wall_s": round(dt, 3),
            "speedup": round(base / dt, 3),
            "efficiency": round(base / dt / n, 3),
            "final_cost": round(final_cost, 2),
            "initial_cost": round(float(info["initial_cost"]), 2)})
        log(f"  partitioned-BA mesh n={n}: {dt*1e3:.0f} ms "
            f"speedup {base/dt:.2f}x eff {base/dt/n*100:.0f}%")

    # Comm-model projection to 2 hosts x 4 GPUs.
    n_obs = out.get("n_obs", 0)
    per_block_flops = (n_obs / max(ba_blocks, 1)) * 1200.0 * ba_iters
    exchange_bytes = views * 6 * 4 + len(out.get("points", [])) * 3 * 4
    t_comp = per_block_flops / (PEAK_F32_FLOPS * 0.02)  # 2% of the peak
    t_comm = exchange_bytes / NIC_BW
    proj_eff = t_comp / (t_comp + t_comm)
    log(f"  2x4 projection: block compute {t_comp*1e3:.2f} ms + boundary "
        f"exchange {t_comm*1e3:.2f} ms -> {proj_eff*100:.1f}% efficiency")

    return {
        "config": 5,
        "frontend": "real (SIFT on the rendered room, "
                    + room_scene() + ")",
        "views": views,
        "resolution": list(hw),
        "kp_per_view": round(n_kp, 1),
        "pairs": len(pairs),
        "edges": int(out["num_edges"]),
        "points": int(len(out["points"])),
        "observations": int(out.get("n_obs", 0)),
        "ate": round(float(err), 4),
        "total_sfm_s": round(total_sfm, 1),
        "stage_times_s": {k: round(v, 2) for k, v in stage_t.items()},
        "ba_blocks": ba_blocks,
        "ba_sweeps": ba_sweeps,
        "mesh_devices": mesh_devices,
        "partitioned_ba_scaling": scaling_rows,
        "host_physical_cores": multiprocessing.cpu_count(),
        "scaling_caveat": (
            f"a mesh is the torch.distributed world of this process "
            f"({world} rank(s)); the comm structure: no cross-block "
            f"traffic within a sweep, an O(C*6) boundary exchange between"),
        "projected_2x4_efficiency": round(proj_eff, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=128)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--total-capacity", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--ba-blocks", type=int, default=8)
    ap.add_argument("--ba-sweeps", type=int, default=3)
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=1,
                    help="ranks of the BA's block mesh (> 1: the "
                    "torch.distributed world this process is in)")
    ap.add_argument("--json", default="torch_bench_config5_real.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    artifact = run_config5(
        views=args.views, hw=(args.height, args.width), window=args.window,
        capacity=args.capacity, total_capacity=args.total_capacity,
        samples=args.samples, chunk=args.chunk, ba_blocks=args.ba_blocks,
        ba_sweeps=args.ba_sweeps, ba_iters=args.ba_iters,
        mesh_devices=args.mesh, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(artifact, f, indent=1)
        _log(f"wrote {args.json}")
    print(json.dumps({"metric": "config5_real_ate", "value": artifact["ate"],
                      "unit": "ATE", "views": artifact["views"],
                      "total_sfm_s": artifact["total_sfm_s"]}))
    return artifact


if __name__ == "__main__":
    main()
