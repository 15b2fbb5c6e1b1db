"""Witness of batched VO's ATE tail (ROADMAP §3, F6).

The A/B VO probe's runs (``scripts/probe_ab_vo.py`` and its twin): 20
renders of the room loop at 240x320 (``make_room(seed=1)``, the frames of
``scripts/torch_probe_batch_parity.py::render_frames``, the same for both
packages) through ``process_frames`` (``--mode batched``) or
``process_frame`` (``--mode per_frame``) with the probes' configuration,
the pipeline's random source seeded ``1000 + seed`` as the probes seed it.

- For each ``k`` of ``--jitter`` a run scales ``BAOptions.lambda_init`` by
  (1 + k 1e-6), the perturbation of ``tests/loop_witness.py``: where the
  float32 (bfloat16-working) BA stops turns on such last-bit changes in
  both packages. ``--ba float64`` runs the port's VO BA in float64 (the
  reference builds its BA problem in JAX's default dtype: float64 only
  under x64, which moves every other stage too).
- ``--capture DIR`` (the port) saves every BA problem of each run, as the
  pipeline handed it to ``bundle_adjust``, with the port's float32 and
  float64 solutions, into ``DIR/ba_<seed>_<call>.npz``; ``--replay DIR``
  (the reference) solves each saved problem with the reference's float32
  BA and prints, per call, each float32 solution's largest pose error
  from the port's float64 solution.

    JAX_PLATFORMS=cpu python tests/ab_vo_witness.py --package jax \\
        --seeds 5 1 --jitter -2 -1 1 2
    python tests/ab_vo_witness.py --package torch --seeds 12 --ba float64
    python tests/ab_vo_witness.py --package torch --seeds 12 --capture D
    JAX_PLATFORMS=cpu python tests/ab_vo_witness.py --package jax --replay D

Prints one JSON line per run or per replayed call. A run takes ~1-3 min on
an 8-core CPU with one torch thread for the port, ~2-4 min for the
reference; the replay of one run's 18 problems ~1 min.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "tests", ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FRAMES, HW = 20, (240, 320)


def _config(OdometryConfig, scale):
    cfg = OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=8)
    return dataclasses.replace(cfg, ba_options=cfg.ba_options._replace(
        lambda_init=cfg.ba_options.lambda_init * scale))


def _jax_pipeline(K, seed, scale, ba):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sara_tpu.sfm import OdometryConfig, OdometryPipeline

    if ba != "float32":
        raise SystemExit("the reference's VO BA runs in float32 here")
    pipe = OdometryPipeline(K, _config(OdometryConfig, scale))
    pipe._key = jax.random.PRNGKey(1000 + seed)
    return pipe, jax.numpy.asarray


def _torch_pipeline(K, seed, scale, ba):
    import torch

    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.utils.host import put

    pipe = OdometryPipeline(K, _config(OdometryConfig, scale), device="cpu")
    pipe._gen.manual_seed(1000 + seed)
    if ba == "float64":
        run = pipe._bundle_adjust
        f32 = pipe._f32

        def bundle_adjust_float64(*a, **k):
            pipe._f32 = lambda x: put(np.asarray(x, np.float64), "cpu")
            try:
                return run(*a, **k)
            finally:
                pipe._f32 = f32

        pipe._bundle_adjust = bundle_adjust_float64
    return pipe, torch.as_tensor


def _capturing(bundle_adjust, problems):
    """``bundle_adjust`` that keeps each call's problem and options."""
    def run(prob, opts):
        problems.append((prob, opts))
        return bundle_adjust(prob, opts)
    return run


def _save(directory, seed, problems):
    """Each captured problem with the port's float32 and float64 solutions
    into ``directory/ba_<seed>_<call>.npz``."""
    import torch

    from sara_tpu_torch.ba import bundle_adjust

    os.makedirs(directory, exist_ok=True)
    for call, (prob, opts) in enumerate(problems):
        sols = {}
        for dt in (torch.float32, torch.float64):
            p = prob._replace(**{f: getattr(prob, f).to(dt) for f in
                                 ("poses", "points", "intrinsics", "uv")})
            sols[str(dt).split(".")[-1]] = bundle_adjust(p, opts)[0] \
                .poses.double().numpy()
        fields = {f: v.cpu().numpy() for f, v in prob._asdict().items()
                  if v is not None}
        np.savez(os.path.join(directory, f"ba_{seed}_{call:02d}.npz"),
                 max_iters=opts.max_iters, **fields,
                 **{f"solution_{k}": v for k, v in sols.items()})


def run_once(args, K, imgs, centers, seed, k) -> dict:
    from sara_tpu_torch.utils import ate_rmse

    make = _jax_pipeline if args.package == "jax" else _torch_pipeline
    pipe, put = make(K, seed, 1.0 + k * 1e-6, args.ba)
    problems = []
    if args.capture:
        from sara_tpu_torch.sfm import odometry

        bundle_adjust = odometry.bundle_adjust
        odometry.bundle_adjust = _capturing(bundle_adjust, problems)
    frames = [put(im) for im in imgs]
    t0 = time.perf_counter()
    try:
        if args.mode == "per_frame":
            ok = [bool(pipe.process_frame(im, f))
                  for f, im in enumerate(frames)]
        else:
            ok = [bool(v) for v in pipe.process_frames(
                frames, list(range(len(frames))))]
    finally:
        if args.capture:
            odometry.bundle_adjust = bundle_adjust
    ate = float(ate_rmse(np.asarray(pipe.pose_graph.trajectory()),
                         centers[np.flatnonzero(ok)]))
    if args.capture:
        _save(args.capture, seed, problems)
    return {"package": args.package, "mode": args.mode, "seed": seed,
            "k": k, "ba": args.ba, "accepted": int(sum(ok)),
            "ate": round(ate, 4), "ba_calls": len(problems),
            "seconds": round(time.perf_counter() - t0, 1)}


def replay(directory) -> None:
    """The reference's float32 BA on every problem saved by ``--capture``:
    per call, the largest pose error of its solution and of the port's
    float32 one from the port's float64 solution."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sara_tpu.ba import BAOptions, BAProblem, bundle_adjust

    for path in sorted(glob.glob(os.path.join(directory, "ba_*.npz"))):
        d = np.load(path)
        prob = BAProblem(**{f: jnp.asarray(d[f]) for f in BAProblem._fields
                            if f in d})
        ref = np.asarray(bundle_adjust(prob, BAOptions(
            max_iters=int(d["max_iters"])))[0].poses, np.float64)
        p64 = d["solution_float64"]
        print(json.dumps({
            "problem": os.path.basename(path),
            "reference_f32_from_f64": round(float(np.abs(ref - p64).max()),
                                            6),
            "port_f32_from_f64": round(float(np.abs(
                d["solution_float32"] - p64).max()), 6),
            "reference_from_port_f32": round(float(np.abs(
                ref - d["solution_float32"]).max()), 6)}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--mode", choices=("batched", "per_frame"),
                    default="batched")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--jitter", type=int, nargs="+", default=[0],
                    help="k of each run: lambda_init x (1 + k * 1e-6)")
    ap.add_argument("--ba", choices=("float32", "float64"),
                    default="float32", help="the port's VO BA dtype")
    ap.add_argument("--capture", default="",
                    help="the port: save each BA problem into this dir")
    ap.add_argument("--replay", default="",
                    help="the reference: solve the problems saved here")
    args = ap.parse_args(argv)
    if args.replay:
        return replay(args.replay)
    if args.capture and args.package != "torch":
        raise SystemExit("--capture records the port's BA problems")
    import torch

    torch.set_num_threads(1)
    from torch_probe_batch_parity import render_frames

    K, imgs, _, centers = render_frames(FRAMES, HW)
    centers = np.asarray(centers)
    for seed in args.seeds:
        for k in args.jitter:
            print(json.dumps(run_once(args, K, imgs, centers, seed, k)),
                  flush=True)


if __name__ == "__main__":
    main()
