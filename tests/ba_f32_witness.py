"""The float32 end-to-end dense BA problem of ``tests/test_torch_ba.py``
through both packages, beside its float64 solution, for a witness of where
each float32 run stops.

    JAX_PLATFORMS=cpu python tests/ba_f32_witness.py

The problem is ``tests/test_ba.py::_make_ba_problem(n_bad_obs=6)`` (seed
0: 4 cameras, 60 points, 0.5 px noise, 6 bad observations) with camera 0
and one translation component of camera 1 frozen, 15 dense LM iterations.
It is solved in float64 and in float32 by each package. One JSON line:
the final costs; for each float32 run its cost, its largest point error
(``point_err``) and pose error (``pose_err``) from the reference's
float64 solution and its point scale against it; and the two float32 runs'
largest point and pose differences from each other.

On an 8-core Intel Xeon (JAX 0.9.0, torch 2.13.0+cpu) it printed: float64
cost 560.8956 in both packages; float32 reference 561.8639, point_err
1.1578, pose_err 0.0241; port 561.5926, 0.9842, 0.0156; the two float32
runs 0.1853 apart in the points and 0.0085 in the poses. On an 8-core AMD
EPYC the reference's run was the same and the port's stopped at 561.7192,
point_err 1.0752. ``tests/test_torch_ba.py::test_bundle_adjust_end_to_end``
holds the port's float32 dense run to these errors.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from sara_tpu.ba import BAOptions, bundle_adjust
    from sara_tpu_torch.ba import bundle_adjust as tbundle_adjust
    from sara_tpu_torch.convert import ba_problem_from_numpy, params_from_jax
    from test_ba import _make_ba_problem

    torch.set_num_threads(1)
    prob, *_ = _make_ba_problem(n_bad_obs=6)
    pf = np.zeros((4, 6), bool)
    pf[0] = True
    pf[1, 3] = True
    prob = prob._replace(pose_fixed=jnp.asarray(pf))
    opts = BAOptions(max_iters=15, cg_iters=20, solver="dense")
    out = {}
    for dtype in ("float64", "float32"):
        p = prob._replace(**{k: jnp.asarray(np.asarray(getattr(prob, k)),
                                            getattr(jnp, dtype))
                             for k in ("poses", "points", "intrinsics",
                                       "uv")})
        jout, jinfo = bundle_adjust(p, opts)
        tout, tinfo = tbundle_adjust(ba_problem_from_numpy(
            [None if f is None else np.asarray(f) for f in p], "cpu"),
            params_from_jax(opts))
        out[dtype] = dict(
            jax=(float(jinfo["final_cost"]), np.asarray(jout.poses, float),
                 np.asarray(jout.points, float)),
            torch=(float(tinfo["final_cost"]), tout.poses.double().numpy(),
                   tout.points.double().numpy()))
    ref_cost, ref_poses, ref_pts = out["float64"]["jax"]
    line = {"float64_cost": {k: v[0] for k, v in out["float64"].items()},
            "float64_points_jax_vs_torch": float(np.abs(
                out["float64"]["torch"][2] - ref_pts).max())}
    for pkg in ("jax", "torch"):
        cost, poses, pts = out["float32"][pkg]
        line[f"float32_{pkg}"] = dict(
            cost=cost, cost_over_float64=cost / ref_cost - 1.0,
            point_err=float(np.abs(pts - ref_pts).max()),
            pose_err=float(np.abs(poses - ref_poses).max()),
            point_scale=float(np.linalg.norm(pts - pts.mean(0))
                              / np.linalg.norm(ref_pts - ref_pts.mean(0))))
    j32, t32 = out["float32"]["jax"], out["float32"]["torch"]
    line["float32_jax_vs_torch"] = dict(
        point_diff=float(np.abs(j32[2] - t32[2]).max()),
        pose_diff=float(np.abs(j32[1] - t32[1]).max()))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
