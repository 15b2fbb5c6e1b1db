"""The global SfM demo's float32 bundle adjustment beside its float64
solution, for a witness of where each float32 solve stops.

    python tests/sfm_f32_witness.py capture --device cuda --runs 4 --dir D
    JAX_PLATFORMS=cpu python tests/sfm_f32_witness.py replay --dir D

``capture`` runs ``examples/torch_global_sfm_demo.py`` (8 views of the
rendered room, its defaults) ``--runs`` times on ``--device`` and saves
each run's BA problem, as triangulation handed it to the BA, with the
true centres into ``D/problem_<run>.npz``. One JSON line per run: the
float32 ATE, the BA's costs, and the ATE and cost of the float64 solution
of the same problem on the same device.

``replay`` solves every saved problem on the CPU with the pipeline's BA
options: in float32 and float64 by the port, and in float32 by the
reference package. One JSON line per problem: each solve's ATE against
the true centres and its final cost. With ``--jitter N`` each package
also solves the problem N more times in float32, its points scaled by
1 + 1e-6 g (g standard normal from ``RandomState(seed)``, seeds 1..N, a
few ulps), and the line gains each package's list of those ATEs.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

FLOAT_FIELDS = ("poses", "points", "intrinsics", "uv")


def capture(args):
    import torch

    import chip_smoke as cs

    os.makedirs(args.dir, exist_ok=True)
    argv = ["--views", str(args.views), "--out", args.dir]
    if torch.device(args.device).type == "cpu":
        argv.append("--cpu")
    demo = cs.load_demo("global_sfm")
    for run in range(args.runs):
        with contextlib.redirect_stdout(io.StringIO()):
            out = demo.main(argv)
        ate64, cost64 = cs.sfm_float64_solution(out)
        prob = out["ba_problem"]
        np.savez(os.path.join(args.dir, f"problem_{run}.npz"),
                 centers=out["centers"], ate=out["ate"],
                 **{k: v.cpu().numpy() for k, v in prob._asdict().items()
                    if v is not None})
        print(json.dumps(dict(
            run=run, device=args.device, edges=out["edges"],
            points=out["points"], ate_float32=out["ate"],
            initial_cost=float(out["ba_info"]["initial_cost"]),
            final_cost_float32=float(out["ba_info"]["final_cost"]),
            ate_float64=ate64, final_cost_float64=cost64)), flush=True)


def replay(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from sara_tpu.ba import BAProblem as JBAProblem
    from sara_tpu.ba import bundle_adjust as jbundle_adjust
    from sara_tpu.sfm.global_sfm import GlobalSfMConfig as JConfig
    from sara_tpu_torch.ba import BAProblem, bundle_adjust
    from sara_tpu_torch.core import lie
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig
    from sara_tpu_torch.utils import ate_rmse

    torch.set_num_threads(1)

    def ate_of(poses, centers):
        poses = torch.as_tensor(np.asarray(poses, np.float64))
        R = lie.so3_exp(poses[:, :3])
        est = -(R.transpose(1, 2) @ poses[:, 3:, None])[..., 0]
        return ate_rmse(est.numpy(), centers)

    def port(d, fields, dtype, points):
        prob = BAProblem(**{f: torch.as_tensor(d[f]).to(dtype)
                            if f in FLOAT_FIELDS else torch.as_tensor(d[f])
                            for f in fields})
        prob = prob._replace(points=torch.as_tensor(points).to(dtype))
        res, info = bundle_adjust(prob, GlobalSfMConfig().ba_options)
        return ate_of(res.poses, d["centers"]), float(info["final_cost"])

    def reference(d, fields, points):
        prob = JBAProblem(**{f: jnp.asarray(d[f], jnp.float32)
                             if f in FLOAT_FIELDS else jnp.asarray(d[f])
                             for f in fields})
        prob = prob._replace(points=jnp.asarray(points, jnp.float32))
        res, info = jbundle_adjust(prob, JConfig().ba_options)
        return ate_of(res.poses, d["centers"]), float(info["final_cost"])

    for path in sorted(glob.glob(os.path.join(args.dir, "problem_*.npz"))):
        d = np.load(path)
        fields = [f for f in BAProblem._fields if f in d.files]
        pts = d["points"]
        line = dict(problem=os.path.basename(path),
                    ate_float32_captured=float(d["ate"]))
        for name, solve in (
                ("port_float32", lambda p: port(d, fields, torch.float32, p)),
                ("port_float64", lambda p: port(d, fields, torch.float64, p)),
                ("reference_float32", lambda p: reference(d, fields, p))):
            ate, cost = solve(pts)
            line[name] = dict(ate=ate, final_cost=cost)
        jittered = [(pts * (1 + 1e-6 * np.random.RandomState(seed).normal(
            size=pts.shape))).astype(np.float32)
            for seed in range(1, args.jitter + 1)]
        if jittered:
            line["jitter_port_float32"] = [
                port(d, fields, torch.float32, p)[0] for p in jittered]
            line["jitter_reference_float32"] = [
                reference(d, fields, p)[0] for p in jittered]
        print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("capture", "replay"))
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--jitter", type=int, default=0)
    args = ap.parse_args()
    if args.mode == "capture":
        capture(args)
    else:
        replay(args)


if __name__ == "__main__":
    main()
