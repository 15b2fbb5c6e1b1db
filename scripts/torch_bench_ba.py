"""Bundle-adjustment scale benchmark (BASELINE config 4 flavour) on the
PyTorch / CUDA port.

Twin of ``scripts/bench_ba.py``: LM iterations/s of the Schur-complement
bundle adjuster on synthetic float32 problems of increasing size, for the
dense-Schur and the matrix-free CG solver, the dense solver again on
pre-packed strata and through a ``DenseSchurSession`` re-solve, each
beside the H100's roofline (``utils/roofline``). ``--scipy-anchor`` adds
scipy's TRF + LSMR on the same problem (on the host), ``--mesh`` the
sharded solver on the ``torch.distributed`` world this process belongs to
(a world of one on one card: n = 1 only). Every timing ends in a host read
of the final cost.

It imports only ``sara_tpu_torch``, numpy and scipy, and runs on the card
unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_bench_ba.py [--device cpu]
       [--sizes small,medium,large]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np

SIZES = {
    "small": dict(C=16, P=2_000, O=16_000),
    "medium": dict(C=64, P=20_000, O=160_000),
    "large": dict(C=256, P=100_000, O=800_000),
    "xl": dict(C=512, P=300_000, O=2_400_000),
}


def make_problem(C, P, O, seed=0, device="cuda"):
    """The tool's problem: P points in front of C cameras along the x axis,
    O random observations with 0.5 px noise, poses and points perturbed,
    camera 0 fixed; a float32 ``BAProblem`` on ``device``."""
    import torch
    from scipy.spatial.transform import Rotation

    from sara_tpu_torch.ba import BAProblem

    rs = np.random.RandomState(seed)
    X = rs.uniform(-10, 10, (P, 3)) + np.array([0, 0, 30.0])
    intr = np.array([800.0, 800.0, 512.0, 384.0])
    poses = np.zeros((C, 6))
    poses[:, 3] = np.linspace(0, 10.0, C)
    poses[:, :3] = rs.normal(scale=0.01, size=(C, 3))
    cam_idx = rs.randint(0, C, O).astype(np.int32)
    pt_idx = rs.randint(0, P, O).astype(np.int32)
    Rm = Rotation.from_rotvec(poses[:, :3]).as_matrix()
    Xc = np.einsum("oij,oj->oi", Rm[cam_idx], X[pt_idx]) + poses[cam_idx, 3:]
    z = np.clip(Xc[:, 2], 1.0, None)
    uv = np.stack([intr[0] * Xc[:, 0] / z + intr[2],
                   intr[1] * Xc[:, 1] / z + intr[3]], axis=1)
    uv += rs.normal(scale=0.5, size=uv.shape)
    pose_fixed = np.zeros(C, bool)
    pose_fixed[0] = True

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def on(a):
        return torch.as_tensor(a, device=device)

    return BAProblem(
        poses=f32(poses + np.concatenate(
            [np.zeros((1, 6)), rs.normal(scale=2e-3, size=(C - 1, 6))])),
        points=f32(X + rs.normal(scale=5e-2, size=X.shape)),
        intrinsics=f32(intr), cam_idx=on(cam_idx), pt_idx=on(pt_idx),
        uv=f32(uv), obs_mask=on(np.ones(O, bool)),
        pose_fixed=on(pose_fixed), point_fixed=on(np.zeros(P, bool)))


def scipy_anchor(prob, opts, max_nfev=12):
    """External LM anchor: scipy.optimize.least_squares (TRF + LSMR, Huber
    loss, analytic sparse Jacobian from the port's closed-form Jacobians)
    on the same problem, timed on the host. Returns the wall time, the
    evaluations and the final trimmed-Huber cost by the port's
    ``ba_cost``."""
    import torch
    from scipy.optimize import least_squares
    from scipy.sparse import coo_matrix

    from sara_tpu_torch.ba import ba_cost
    from sara_tpu_torch.ba.jacobian import pinhole_jacobians_gathered

    dev = prob.poses.device
    cam = prob.cam_idx.cpu().numpy()
    pt = prob.pt_idx.cpu().numpy()
    cam_t, pt_t = prob.cam_idx.long(), prob.pt_idx.long()
    C = int(prob.poses.shape[0])
    P = int(prob.points.shape[0])
    O = len(cam)
    pose0 = prob.poses[0].cpu().numpy()
    delta = opts.huber_delta

    def rj(poses, points):
        pc = poses[cam_t]
        return pinhole_jacobians_gathered(pc[:, :3], pc[:, 3:],
                                          points[pt_t], prob.intrinsics,
                                          prob.uv)

    def unpack(x):
        poses = np.concatenate(
            [pose0[None], x[:6 * (C - 1)].reshape(C - 1, 6)])
        points = x[6 * (C - 1):].reshape(P, 3)
        return (torch.as_tensor(poses, dtype=torch.float32, device=dev),
                torch.as_tensor(points, dtype=torch.float32, device=dev))

    def fun(x):
        r, _, _ = rj(*unpack(x))
        return r.double().cpu().numpy().ravel()

    # Static sparsity: rows 2o / 2o+1; 6 columns per free camera and 3 per
    # point.
    free_cam = cam >= 1
    rows_c = np.repeat(2 * np.arange(O)[free_cam], 6)
    cols_c6 = (6 * (cam[free_cam] - 1))[:, None] + np.arange(6)[None, :]
    rows_p = np.repeat(2 * np.arange(O), 3)
    cols_p3 = (6 * (C - 1) + 3 * pt)[:, None] + np.arange(3)[None, :]
    rows = np.concatenate([rows_c, rows_c + 1, rows_p, rows_p + 1])
    cols = np.concatenate([cols_c6.ravel(), cols_c6.ravel(),
                           cols_p3.ravel(), cols_p3.ravel()])
    n_params = 6 * (C - 1) + 3 * P

    def jac(x):
        _, Jcf, Jpf = rj(*unpack(x))
        Jcf = Jcf.double().cpu().numpy()
        Jpf = Jpf.double().cpu().numpy()
        data = np.concatenate([
            Jcf[free_cam, :6].ravel(), Jcf[free_cam, 6:].ravel(),
            Jpf[:, :3].ravel(), Jpf[:, 3:].ravel()])
        return coo_matrix((data, (rows, cols)),
                          shape=(2 * O, n_params)).tocsr()

    x0 = np.concatenate([prob.poses[1:].cpu().numpy().ravel(),
                         prob.points.cpu().numpy().ravel()]).astype(
        np.float64)
    fun(x0), jac(x0)  # warm outside the timed region
    t0 = time.perf_counter()
    res = least_squares(fun, x0, jac=jac, method="trf", loss="huber",
                        f_scale=delta, max_nfev=max_nfev, tr_solver="lsmr",
                        verbose=0)
    wall = time.perf_counter() - t0
    poses_f, points_f = unpack(res.x)
    final = float(ba_cost(prob._replace(poses=poses_f, points=points_f),
                          opts.huber_delta, opts.outlier_cutoff))
    return {"wall_s": wall, "nfev": int(res.njev or res.nfev),
            "s_per_jac_eval": wall / max(int(res.njev or res.nfev), 1),
            "final_cost_ours": final, "scipy_cost": float(res.cost),
            "status": int(res.status)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="small,medium")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cg", type=int, default=15)
    ap.add_argument("--solvers", default="dense,cg",
                    help="comma list: dense (explicit Schur direct), cg "
                    "(matrix-free Schur+PCG)")
    ap.add_argument("--json", default="",
                    help="write per-size results to this JSON file")
    ap.add_argument("--scipy-anchor", action="store_true",
                    help="also run scipy's TRF+LSMR on each size (host)")
    ap.add_argument("--anchor-nfev", type=int, default=12)
    ap.add_argument("--mesh", action="store_true",
                    help="also time the sharded solver over the ranks of "
                    "this process's torch.distributed world (one card: a "
                    "world of one)")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba import BAOptions, DenseSchurSession, bundle_adjust
    from sara_tpu_torch.ba.dense_schur import (
        dense_schur_bundle_adjust_strata, pack_pt_major_strata)
    from sara_tpu_torch.utils.roofline import ba_lm_iteration, report

    dev = resolve_device(args.device)
    results = {}
    for name in args.sizes.split(","):
        cfg = SIZES[name]
        prob = make_problem(**cfg, device=dev)
        results[name] = dict(cfg)
        for solver in filter(None, args.solvers.split(",")):
            opts = BAOptions(max_iters=args.iters, cg_iters=args.cg,
                             solver=solver)
            t0 = time.perf_counter()
            out, info = bundle_adjust(prob, opts)
            c = float(info["final_cost"])
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out, info = bundle_adjust(prob, opts)
            c = float(info["final_cost"])
            run_s = time.perf_counter() - t0
            ips = args.iters / run_s
            print(f"{name}[{solver}]: C={cfg['C']} P={cfg['P']} "
                  f"O={cfg['O']}  compile+1st={compile_s:.1f}s  "
                  f"run={run_s*1e3:.0f}ms  {ips:.2f} LM iters/s  "
                  f"cost {float(info['initial_cost']):.1f}->{c:.1f}",
                  flush=True)
            est = ba_lm_iteration(cfg["C"], cfg["P"], cfg["O"], args.cg)
            tag = ("" if dev.type == "cuda"
                   else "  [H100 roofline; CPU run - reference only]")
            print("  " + report(f"{name}/LM-iter", est, run_s / args.iters)
                  + tag, flush=True)
            results[name][solver] = {
                "lm_iters_per_s": ips,
                "ms_per_lm_iter": run_s * 1e3 / args.iters,
                "compile_s": compile_s, "final_cost": c,
                "initial_cost": float(info["initial_cost"]),
                "roofline_frac": est.roofline_seconds() / (run_s / args.iters),
            }
            if solver == "dense":
                # The solver alone on pre-packed strata (no host packing).
                strata, _ids, st = pack_pt_major_strata(
                    prob, chunk=opts.dense_chunk)
                Qs = tuple(st["chunks"])
                _, _, inf0 = dense_schur_bundle_adjust_strata(
                    tuple(strata), opts, Qs)
                float(inf0["final_cost"])
                t0 = time.perf_counter()
                _, _, inf1 = dense_schur_bundle_adjust_strata(
                    tuple(strata), opts, Qs)
                float(inf1["final_cost"])
                dev_s = time.perf_counter() - t0
                print(f"{name}[dense/device-resident]: "
                      f"run={dev_s*1e3:.0f}ms  "
                      f"{args.iters/dev_s:.2f} LM iters/s", flush=True)
                results[name]["dense_device"] = {
                    "lm_iters_per_s": args.iters / dev_s,
                    "ms_per_lm_iter": dev_s * 1e3 / args.iters,
                }
                # DenseSchurSession packs once; a re-solve is the steady
                # cost of windowed or restarted BA.
                sess = DenseSchurSession(prob, opts)
                _, _, i0 = sess.solve(poses=prob.poses, points=prob.points)
                float(i0["final_cost"])
                t0 = time.perf_counter()
                _, _, i1 = sess.solve(poses=prob.poses, points=prob.points)
                float(i1["final_cost"])
                sess_s = time.perf_counter() - t0
                print(f"{name}[dense/session-resolve]: "
                      f"run={sess_s*1e3:.0f}ms  "
                      f"{args.iters/sess_s:.2f} LM iters/s "
                      f"({sess_s/dev_s:.2f}x device-resident)", flush=True)
                results[name]["dense_session"] = {
                    "lm_iters_per_s": args.iters / sess_s,
                    "ms_per_lm_iter": sess_s * 1e3 / args.iters,
                    "vs_device_resident": sess_s / dev_s,
                }
        if args.scipy_anchor:
            opts_a = BAOptions(max_iters=args.iters)
            a = scipy_anchor(prob, opts_a, max_nfev=args.anchor_nfev)
            print(f"{name}[scipy-anchor trf+lsmr]: wall={a['wall_s']:.1f}s "
                  f"({a['s_per_jac_eval']*1e3:.0f} ms/jac-eval, "
                  f"{a['nfev']} evals)  our-cost {a['final_cost_ours']:.1f}",
                  flush=True)
            results[name]["scipy_anchor"] = a

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"backend": dev.type, "lm_iters": args.iters,
                       "cg_iters": args.cg, "results": results}, f, indent=1)
        print("wrote", args.json, flush=True)

    if args.mesh:
        import torch.distributed as dist

        from sara_tpu_torch.parallel import (BACommModel,
                                             distributed_bundle_adjust,
                                             make_mesh)

        mesh = make_mesh(device=dev)    # the world this process is in
        n = dist.get_world_size()
        print("  " + BACommModel(cfg["C"], cfg["P"], cfg["O"], args.cg,
                                 n).report(), flush=True)
        out, info = distributed_bundle_adjust(prob, mesh, opts)
        float(info["final_cost"])
        t0 = time.perf_counter()
        out, info = distributed_bundle_adjust(prob, mesh, opts)
        float(info["final_cost"])
        dt = time.perf_counter() - t0
        print(f"  mesh n={n}: {dt*1e3:.0f} ms", flush=True)
        results["mesh"] = [{"n": n, "ms": dt * 1e3,
                            "final_cost": float(info["final_cost"])}]
    return results


if __name__ == "__main__":
    main()
