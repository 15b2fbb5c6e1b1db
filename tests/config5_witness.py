"""Witness of F10: config 5's real-frontend SfM (``bench_config5_real`` at
32 views), the port against the reference, as distributions of ATE over
seeds, and the port on the card run alone, after the tools that precede it
in ``chip_smoke.TOOL_RUNS``, and at other seeds (ROADMAP §3).

The cut is the twin's in phase "tools": 32 views of the room loop at
240x320 (``torch_eval_vo.room_loop``: the reference's photographs, else
``make_room(seed=1)``), the tools' SIFT parameters (first_octave 0,
capacities 1024 / 2048, 2 refinements) and SfM parameters (window 3, 256
hypotheses, chunks of 16 pairs, 20 inliers, the partitioned BA: 8 blocks,
3 sweeps, 10 iterations), no mesh. Neither tool is edited: the CPU mode
calls both packages' ``compute_sift_keypoints`` and ``run_global_sfm``
with those parameters; the card mode runs the twin's own ``main`` with
``run_global_sfm`` wrapped to record a digest (and to pass a generator
where a seed is asked for).

Every run records a digest of each stage's output, so that runs that
part are pinned to the first stage where they differ:

- ``kp``: per-view keypoint counts, a hash of the keypoints rounded (xy
  to 0.01 px, scale and orientation to 1e-3) and of their exact bytes;
- ``edges``: the verified edges with their inlier counts, and a hash;
- ``rot``: rotation averaging's mean and largest error against the truth
  (degrees, gauge of view 0);
- ``ate_averaged``, ``ate_polished``, ``ate``: the centres after
  translation averaging, after the pose-graph polish and after the BA;
  ``ba``: the BA's initial and final cost.

CPU mode (the reference WITHOUT x64, as its users run it; the port with
one torch thread; XLA single-threaded so several runs share the cores):

    python tests/config5_witness.py keypoints --package jax --out D/kps_jax.npz
    python tests/config5_witness.py keypoints --package torch --out D/kps_torch.npz
    python tests/config5_witness.py run --packages jax,torch --seeds 0-47 \\
        --kps D --workers 6 --out D/runs.jsonl
    python tests/config5_witness.py summary D/runs.jsonl

Detection does not depend on the seed, so each package's keypoints are
detected once and every seed costs one ``run_global_sfm``. ``run`` starts
``--workers`` subprocesses, each running a share of one package's seeds in
one interpreter (the reference compiles once), and appends each run's JSON
line to ``--out`` (runs already there are skipped: it resumes).
``summary`` prints each seed's ATE per package, the medians, quartiles,
the port / reference median ratio with its bootstrap 95% interval and the
Mann-Whitney p (``vo_gap_witness.compare``: a gap is real where p < 0.01
and the interval excludes 1), each package's share of runs above the
gate's 0.5, and the same comparison for each stage's number.

Card mode (imports nothing of JAX):

    python tests/config5_witness.py card --repeat 4 --seeds 1-8 \\
        --out chiprun_out/config5

runs, each in a fresh interpreter: (a) ``alone``: the twin at seed 0
``--repeat`` times in one process; (b) ``after_tools``: the runs of
``chip_smoke.TOOL_RUNS`` before ``bench_config5_real``, then it, through
``chip_smoke.phase_tools`` as phase "tools" runs them (its gates' verdict
is recorded, not raised); (c) ``seeds``: the twin once at each of
``--seeds``; with ``--modes ...,script``, (d) the whole
``chip_smoke.main()`` (~15 min), its config-5 run recorded. Each run's
digest is one JSON line of ``--out``/card.jsonl; ``card-summary`` prints
where the runs part. The first ``alone`` run's keypoints and pair-chunk
outputs are saved to ``--out``/capture.npz.

Replay (CPU, both packages' stages 3-6 from the card's epipolar graph):

    python tests/config5_witness.py run --packages jax,torch --seeds 0-23 \
        --capture D/capture.npz --workers 6 --out D/replay.jsonl
    python tests/config5_witness.py summary D/replay.jsonl

Each package's ``run_global_sfm`` gets the card's keypoints and, in place
of its pair-chunk program, the card's chunk outputs in order; "seed" k
turns rotation averaging's output by a random rotation of per-axis spread
``JITTER_RAD`` (``RandomState(k)``; k = 0 none), the size by which the
card's own runs of one seed part there. A run's BA problem can be saved
and solved again by either package's partitioned BA under ``lambda_init``
jitters (F6's loop witness jitter), and each package's BA on every saved
problem with ``--key all --jitters 0``:

    python tests/config5_witness.py replay --package torch \
        --capture D/capture.npz --jitters 47 --save-ba D/ba.npz
    python tests/config5_witness.py lambda --package jax --problem D/ba.npz \
        --key 47 --jitters=-12-12
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "tests", ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

VIEWS, HW = 32, (240, 320)
# scripts/torch_bench_config5_real.py's defaults (and the reference
# tool's), as phase "tools" runs it at --views 32.
SIFT = dict(capacity=1024, total_capacity=2048, refine_iters=2)
SFM = dict(window=3, samples=256, chunk=16, min_pair_inliers=20,
           ba_blocks=8, ba_sweeps=3, ba_iters=10)
PACKAGES = ("jax", "torch")
GATE = 0.5          # chip_smoke.tool_failures' gate on the ATE
KP_FIELDS = ("xy", "scale", "orientation", "response", "descriptors", "mask")
# The digest's numbers, in pipeline order (``summary`` compares each).
STAGES = ("kp_mean", "edges", "inliers_mean", "rot_mean_deg",
          "rot_max_deg", "ate_averaged", "ate_polished", "ate")


def gt_rotations(views=VIEWS) -> np.ndarray:
    """The world -> camera rotations of ``room_loop``'s views (yaw
    0.25 sin a about y, ``torch_eval_vo.room_loop``)."""
    out = []
    for i in range(views):
        yaw = 0.25 * np.sin(2 * np.pi * i / views)
        out.append([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                    [-np.sin(yaw), 0, np.cos(yaw)]])
    return np.asarray(out)


def loop_pairs(views=VIEWS, window=SFM["window"]) -> list:
    """The tools' pairs: the loop's topology only (|i - j| mod V <= window)."""
    return sorted({tuple(sorted((i, (i + d) % views)))
                   for i in range(views) for d in range(1, window + 1)})


def _sha(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def kp_digest(kps) -> dict:
    """Per-view counts and hashes (rounded and exact) of the valid
    keypoints of ``kps`` (either package's Keypoints)."""
    counts, rounded, exact = [], [], []
    for k in kps:
        m = _host(k.mask).astype(bool)
        xy, s, o = (_host(getattr(k, f))[m].astype(np.float32)
                    for f in ("xy", "scale", "orientation"))
        counts.append(int(m.sum()))
        rounded.append(np.concatenate([np.round(xy, 2).ravel(),
                                       np.round(s, 3), np.round(o, 3)]))
        exact += [xy, s, o, _host(k.descriptors)[m].astype(np.float32)]
    return {"counts": counts, "hash": _sha(*rounded), "exact": _sha(*exact)}


def _angle_deg(R) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def sfm_digest(out: dict, centers_gt, R_gt) -> dict:
    """The digest of one ``run_global_sfm`` output: its edges, rotation
    averaging's error, the ATE after each later stage, the BA's costs."""
    from sara_tpu_torch.utils import ate_rmse

    V = len(centers_gt)
    # The tracker holds each verified edge's inlier matches, in edge order.
    edges = [[int(a), int(b), int(len(m))]
             for (a, b), m in zip(out["edges"], out["tracker"].edges_a)]
    Ra = np.asarray(out["R_averaged"], float)
    rot = [_angle_deg((Ra[v] @ Ra[0].T) @ (R_gt[v] @ R_gt[0].T).T)
           for v in range(V)]
    R, t = np.asarray(out["R"], float), np.asarray(out["t"], float)
    centers = np.stack([-R[v].T @ t[v] for v in range(V)])
    info = out["ba_info"]
    return {"edges": edges, "edges_hash": _sha(np.asarray(edges, np.int64)),
            "rot_mean_deg": float(np.mean(rot)),
            "rot_max_deg": float(np.max(rot)),
            "ate_averaged": float(ate_rmse(
                np.asarray(out["centers_averaged"], float), centers_gt)),
            "ate_polished": float(ate_rmse(
                np.asarray(out["centers_polished"], float), centers_gt)),
            "ate": float(ate_rmse(centers, centers_gt)),
            "ba": [float(info["initial_cost"]), float(info["final_cost"])],
            "points": int(len(out["points"]))}


def render():
    """(K, images, centres) of the 32-view loop, as the twin renders it."""
    from torch_eval_vo import room_loop

    return room_loop(VIEWS, HW)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def detect(package: str, imgs) -> list:
    """Each view's keypoints by ``package``'s ``compute_sift_keypoints``
    with the tools' parameters, on the CPU."""
    if package == "jax":
        _jax_cpu()
        import jax.numpy as jnp

        from sara_tpu.features import SIFTParams, compute_sift_keypoints
        from sara_tpu.features.api import DoGParams, PyramidParams

        sp = SIFTParams(pyramid=PyramidParams(first_octave=0),
                        dog=DoGParams(capacity=SIFT["capacity"],
                                      refine_iters=SIFT["refine_iters"]),
                        total_capacity=SIFT["total_capacity"])
        return [compute_sift_keypoints(jnp.asarray(im), sp) for im in imgs]
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.features.api import DoGParams, PyramidParams

    sp = SIFTParams(pyramid=PyramidParams(first_octave=0),
                    dog=DoGParams(capacity=SIFT["capacity"],
                                  refine_iters=SIFT["refine_iters"]),
                    total_capacity=SIFT["total_capacity"],
                    desc_sampler="kernel")
    return [compute_sift_keypoints(im, sp, device="cpu") for im in imgs]


def save_keypoints(package: str, out: str) -> None:
    _, imgs, _ = render()
    kps = detect(package, imgs)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **{f: np.stack([_host(getattr(k, f)) for k in kps])
                     for f in KP_FIELDS})
    print(json.dumps({"package": package, "kp": kp_digest(kps)}))


def keypoints(package: str, d) -> list:
    """Each view's ``package`` Keypoints (on the CPU) from the stacked
    fields ``d`` (``KP_FIELDS``, a leading view axis)."""
    if package == "jax":
        import jax.numpy as jnp

        from sara_tpu.core.types import Keypoints

        return [Keypoints(*(jnp.asarray(d[f][v]) for f in KP_FIELDS))
                for v in range(len(d["mask"]))]
    from sara_tpu_torch.convert import keypoints_from_numpy

    return [keypoints_from_numpy([d[f][v] for f in KP_FIELDS], "cpu")
            for v in range(len(d["mask"]))]


def sfm_config(package: str):
    mod = "sara_tpu" if package == "jax" else "sara_tpu_torch"
    ba = __import__(f"{mod}.ba", fromlist=["BAOptions"])
    g = __import__(f"{mod}.sfm.global_sfm", fromlist=["GlobalSfMConfig"])
    return g, g.GlobalSfMConfig(
        rel_pose_samples=SFM["samples"],
        min_pair_inliers=SFM["min_pair_inliers"], pair_chunk=SFM["chunk"],
        ba_options=ba.BAOptions(max_iters=SFM["ba_iters"]),
        ba_blocks=SFM["ba_blocks"], ba_sweeps=SFM["ba_sweeps"])


def run_seeds(package: str, seeds: list, kps_path: str) -> None:
    """``run_global_sfm`` of ``package`` at each seed on its saved
    keypoints, one JSON line per run (``PRNGKey(seed)`` / a CPU generator
    seeded ``seed``; 0 is both tools' default)."""
    if package == "jax":
        jax = _jax_cpu()
    else:
        import torch

        torch.set_num_threads(1)
    K, _, centers_gt = render()
    R_gt = gt_rotations()
    kps = keypoints(package, np.load(kps_path))
    kp = kp_digest(kps)
    g, cfg = sfm_config(package)
    for seed in seeds:
        t0 = time.perf_counter()
        if package == "jax":
            out = g.run_global_sfm(kps, K, pairs=loop_pairs(), config=cfg,
                                   key=jax.random.PRNGKey(seed))
        else:
            out = g.run_global_sfm(
                kps, K, pairs=loop_pairs(), config=cfg, device="cpu",
                generator=torch.Generator().manual_seed(seed))
        rec = {"package": package, "seed": seed, "kp": kp,
               **sfm_digest(out, centers_gt, R_gt),
               "seconds": round(time.perf_counter() - t0, 1)}
        print(json.dumps(rec), flush=True)


def _seeds(spec: str) -> list:
    """The integers of "first-last" (either may be negative) or "n"."""
    import re

    lo, hi = re.fullmatch(r"(-?\d+)(?:-(-?\d+))?", spec).groups()
    return list(range(int(lo), int(hi or lo) + 1))


def _done(path) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        return {(r["package"], r["seed"])
                for r in map(json.loads, filter(str.strip, fh))}


def _one_thread_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               XLA_FLAGS=(env.get("XLA_FLAGS", "") + " --xla_cpu_multi_"
                          "thread_eigen=false intra_op_parallelism_"
                          "threads=1"))
    return env


def run_many(args) -> None:
    """The seeds of ``args`` for each package, split over ``args.workers``
    subprocesses (each a share of one package's seeds), each line appended
    to ``args.out`` as it comes."""
    done = _done(args.out)
    packages = args.packages.split(",")
    todo = {p: [s for s in _seeds(args.seeds) if (p, s) not in done]
            for p in packages}
    per = max(1, args.workers // len(packages))
    jobs = [(p, todo[p][i::per]) for p in packages for i in range(per)
            if todo[p][i::per]]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lock = threading.Lock()

    def one(job):
        p, seeds = job
        cmd = [sys.executable, str(Path(__file__).resolve())]
        if args.capture:
            cmd += ["replay", "--package", p, "--capture", args.capture,
                    "--jitters", ",".join(map(str, seeds))]
        else:
            cmd += ["seeds", "--package", p, "--seeds",
                    ",".join(map(str, seeds)), "--kps",
                    os.path.join(args.kps, f"kps_{p}.npz")]
        proc = subprocess.Popen(cmd, env=_one_thread_env(), text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        for line in proc.stdout:
            if not line.startswith("{"):
                continue
            with lock:
                with open(args.out, "a") as fh:
                    fh.write(line)
                rec = json.loads(line)
                print(json.dumps({k: rec[k] for k in (
                    "package", "seed", "ate", "rot_mean_deg", "seconds")}),
                    flush=True)
        proc.wait()
        if proc.returncode:
            print(f"FAILED {p} {seeds}: exit {proc.returncode}", flush=True)

    with ThreadPoolExecutor(len(jobs) or 1) as pool:
        list(pool.map(one, jobs))


def _numbers(rec) -> dict:
    """The digest's numbers of one run (``STAGES``)."""
    ins = [e[2] for e in rec["edges"]]
    return {"kp_mean": float(np.mean(rec["kp"]["counts"])),
            "edges": float(len(rec["edges"])),
            "inliers_mean": float(np.mean(ins)) if ins else 0.0,
            **{k: rec[k] for k in STAGES[3:]}}


def decide(port: list, ref: list) -> dict:
    """The witness's decision on two ATE samples: ``vo_gap_witness.compare``
    (real where p < 0.01 and the median ratio's 95% interval excludes
    1), each package's share of runs above ``GATE`` and the two-sided
    Fisher exact p of those two shares."""
    from scipy.stats import fisher_exact

    from vo_gap_witness import compare

    out = compare(port, ref)
    above = [int(np.sum(np.asarray(x) > GATE)) for x in (port, ref)]
    out["share_above_gate"] = [above[0] / len(port), above[1] / len(ref)]
    out["share_p"] = float(fisher_exact(
        [[above[0], len(port) - above[0]],
         [above[1], len(ref) - above[1]]]).pvalue)
    return out


def summary(paths) -> None:
    runs = {}
    for path in paths:
        with open(path) as fh:
            for r in map(json.loads, filter(str.strip, fh)):
                runs[(r["package"], r["seed"])] = r
    seeds = sorted({s for p, s in runs if (("jax", s) in runs
                                             and ("torch", s) in runs)})
    for s in seeds:
        print(json.dumps({"seed": s, **{p: {
            "ate": round(runs[p, s]["ate"], 4),
            "rot_mean_deg": round(runs[p, s]["rot_mean_deg"], 4),
            "edges": len(runs[p, s]["edges"])} for p in PACKAGES}}))
    ate = {p: [runs[p, s]["ate"] for s in seeds] for p in PACKAGES}
    print(json.dumps({"seeds": [seeds[0], seeds[-1]],
                      "ate": decide(ate["torch"], ate["jax"])}))
    for p in PACKAGES:
        kp = {json.dumps(runs[p, s]["kp"]["exact"]) for s in seeds}
        print(json.dumps({"package": p, "kp": runs[p, seeds[0]]["kp"],
                          "kp_digests": len(kp)}))
    nums = {p: [_numbers(runs[p, s]) for s in seeds] for p in PACKAGES}
    for name in STAGES:
        xs = {p: [n[name] for n in nums[p]] for p in PACKAGES}
        if all(np.ptp(v) == 0 for v in xs.values()):
            # The same in every run of each package (detection does not
            # depend on the seed): no distribution to compare.
            print(json.dumps({"stage": name, "constant": [
                xs["torch"][0], xs["jax"][0]]}))
            continue
        c = decide(xs["torch"], xs["jax"])
        print(json.dumps({"stage": name, "median": c["median"],
                          "ratio_ci95": c["ratio_ci95"], "p": c["p"],
                          "real": c["real"]}))




# --- replay: both packages' later stages on the card's pair stage -----------

# Per-axis spread (radians) of the rotation jitter ``replay`` puts on
# rotation averaging's output: the card's runs of one seed part there by
# about this much (the mean error moves by ~3e-3 degrees between runs).
JITTER_RAD = 3e-5


def _so3_exp(w) -> np.ndarray:
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return (np.eye(3) + np.sin(th) / th * W
            + (1 - np.cos(th)) / th ** 2 * W @ W)


def jittered(R: np.ndarray, k: int, rad: float = JITTER_RAD) -> np.ndarray:
    """``R`` (V, 3, 3) each turned by a random rotation of per-axis spread
    ``rad`` drawn from ``RandomState(k)``; ``k`` = 0 leaves it as it is."""
    if k == 0:
        return R
    w = np.random.RandomState(k).normal(scale=rad, size=(len(R), 3))
    return np.stack([_so3_exp(wv) @ Rv for wv, Rv in zip(w, R)]).astype(
        np.float32)


def replay(package: str, capture: str, jitters: list,
           rad: float = JITTER_RAD, save_ba: str = "") -> None:
    """``package``'s ``run_global_sfm`` on the CPU on a card run's capture
    (its keypoints, and its pair chunks' outputs handed back in order in
    place of ``_pair_chunk_program``), so that both packages' stages 3-6
    start from the same epipolar graph; rotation averaging's output is
    turned by ``jittered(R, k, rad)`` for each ``k`` of ``jitters``. One
    JSON line per run, ``seed`` holding ``k``. ``save_ba`` saves each
    run's BA problem (its fields under "k_field"; ``lambda_jitter`` solves
    one again)."""
    d = dict(np.load(capture))
    d["descriptors"] = np.zeros(d["xy"].shape[:2] + (128,), np.float32)
    K = np.asarray(d["K"], np.float64)
    V = len(d["mask"])
    chunks = []
    while f"chunk{len(chunks)}_j" in d:
        chunks.append([d[f"chunk{len(chunks)}_{n}"] for n in CHUNK_OUTPUTS])
    if package == "jax":
        _jax_cpu()
        import jax.numpy as jnp

        import sara_tpu.ba.partitioned as part
        import sara_tpu.sfm.global_sfm as g

        put, kwargs = (lambda a: a), {}
        rotations = lambda R: jnp.asarray(R, jnp.float32)  # noqa: E731
    else:
        import torch

        import sara_tpu_torch.sfm.global_sfm as g

        torch.set_num_threads(1)
        # The port's global SfM imports the partitioned BA by name.
        put, kwargs, part = torch.as_tensor, {"device": "cpu"}, g
        rotations = lambda R: torch.as_tensor(  # noqa: E731
            np.asarray(R, np.float32))
    kps = keypoints(package, d)
    _, cfg = sfm_config(package)
    average, solve = g.average_rotations, part.partitioned_bundle_adjust
    kp = kp_digest(kps)
    problem = {}
    for k in jitters:
        def kept(prob, *a, **kw):
            problem.update({f"{k}_{f}": _host(v) for f, v
                            in prob._asdict().items() if v is not None})
            return solve(prob, *a, **kw)

        part.partitioned_bundle_adjust = kept
        it = iter(chunks)
        g._pair_chunk_program = lambda *a, **kw: tuple(
            put(x) for x in next(it))
        g.average_rotations = lambda *a, **kw: rotations(jittered(
            _host(average(*a, **kw)), k, rad))
        t0 = time.perf_counter()
        out = g.run_global_sfm(kps, K, pairs=loop_pairs(V), config=cfg,
                               **kwargs)
        rec = {"package": package, "seed": k, "jitter_rad": rad, "kp": kp,
               **sfm_digest(out, _centers(V), gt_rotations(V)),
               "seconds": round(time.perf_counter() - t0, 1)}
        print(json.dumps(rec), flush=True)
    if save_ba:
        np.savez(save_ba, **problem)


def lambda_jitter(package: str, problem: str, jitters: list,
                  key: str = "") -> None:
    """``package``'s partitioned BA (config 5's: 8 blocks, 3 sweeps, 10
    iterations) on the CPU on a saved BA problem, with ``lambda_init``
    times (1 + j 1e-6) for each j of ``jitters`` (F6's loop witness
    jitter: where the float32 LM stops turns on the last bits); one JSON
    line per run with the BA's costs and the ATE of its cameras. ``key``
    picks one run's problem of a ``replay --save-ba`` file ("all": each
    in turn)."""
    from sara_tpu_torch.utils import ate_rmse

    d = dict(np.load(problem))
    if key == "all":
        for k in sorted({f.split("_")[0] for f in d}, key=int):
            lambda_jitter(package, problem, jitters, k)
        return
    if key:
        d = {f[len(key) + 1:]: v for f, v in d.items()
             if f.startswith(f"{key}_")}
    if package == "jax":
        _jax_cpu()
        import jax.numpy as jnp

        from sara_tpu.ba import BAOptions, BAProblem
        from sara_tpu.ba.partitioned import partitioned_bundle_adjust

        put = jnp.asarray
    else:
        import torch

        from sara_tpu_torch.ba import BAOptions, BAProblem
        from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust

        torch.set_num_threads(1)
        put = torch.as_tensor
    prob = BAProblem(**{f: put(d[f]) for f in BAProblem._fields
                        if f in d})
    V = len(d["poses"])
    lam0 = BAOptions().lambda_init
    for j in jitters:
        opts = BAOptions(max_iters=SFM["ba_iters"],
                         lambda_init=lam0 * (1 + j * 1e-6))
        out, info = partitioned_bundle_adjust(
            prob, SFM["ba_blocks"], opts, sweeps=SFM["ba_sweeps"])
        P = _host(out.poses).astype(float)
        centers = np.stack([-_so3_exp(p[:3]).T @ p[3:] for p in P])
        print(json.dumps({"package": package, "problem": problem,
                          "key": key, "lambda_jitter": j,
                          "ba": [float(info["initial_cost"]),
                                 float(info["final_cost"])],
                          "ate": float(ate_rmse(centers, _centers(V)))}),
              flush=True)


# --- card mode -------------------------------------------------------------

MODES = ("alone", "after_tools", "seeds", "script")
# The outputs of one pair chunk (``_pair_chunk_program``), in order.
CHUNK_OUTPUTS = ("j", "ok", "inl", "success", "R", "t")


def is_config5(views: int, cfg) -> bool:
    """Whether a ``run_global_sfm`` call is config 5's at the witness's
    cut (other tools and phases call it at other sizes or settings)."""
    return (views == VIEWS and cfg.ba_blocks == SFM["ba_blocks"]
            and cfg.pair_chunk == SFM["chunk"]
            and cfg.rel_pose_samples == SFM["samples"])


def _record_sfm(log: list, seed=None, capture: str = ""):
    """Wrap the port's ``run_global_sfm`` (the twin imports it when it
    runs) so that each call of config 5 appends its digest to ``log``;
    with ``seed``, that call gets a generator on its device seeded so;
    with ``capture`` (a path not yet written), the call's keypoints and
    each pair chunk's outputs are saved there (``replay`` runs both
    packages' later stages on them). Returns the undo."""
    import torch

    import sara_tpu_torch.sfm.global_sfm as g

    run, chunk_program = g.run_global_sfm, g._pair_chunk_program

    def recorded(kps, K, *a, **k):
        cfg = k.get("config", g.GlobalSfMConfig())
        if not is_config5(len(kps), cfg):
            return run(kps, K, *a, **k)
        if seed is not None:
            k["generator"] = torch.Generator(
                device=kps[0].xy.device).manual_seed(seed)
        kp = kp_digest(kps)
        chunks = []
        if capture and not os.path.exists(capture):
            def kept(*ca, **ck):
                outs = chunk_program(*ca, **ck)
                chunks.append([_host(o) for o in outs])
                return outs

            g._pair_chunk_program = kept
        t0 = time.perf_counter()
        try:
            out = run(kps, K, *a, **k)
        finally:
            g._pair_chunk_program = chunk_program
        if chunks:
            # The descriptors are left out: the replay hands the pair
            # stage's outputs back and never matches.
            np.savez(capture, K=np.asarray(K), **{
                f: np.stack([_host(getattr(x, f)) for x in kps])
                for f in KP_FIELDS if f != "descriptors"}, **{
                f"chunk{c}_{n}": v for c, outs in enumerate(chunks)
                for n, v in zip(CHUNK_OUTPUTS, outs)})
        log.append({"kp": kp, **sfm_digest(out, _centers(VIEWS),
                                           gt_rotations(VIEWS)),
                    "sfm_s": round(time.perf_counter() - t0, 2)})
        return out

    g.run_global_sfm = recorded
    return lambda: setattr(g, "run_global_sfm", run)


def _centers(views: int, r_loop: float = 1.6) -> np.ndarray:
    """``room_loop``'s camera centres."""
    a = 2 * np.pi * np.arange(views) / views
    return np.stack([0.5 + r_loop * np.sin(a), np.zeros(views),
                     4.0 + r_loop * (1 - np.cos(a))], axis=1)


def _run_mode(mode: str, device: str, tmp: str) -> str:
    """One run of ``mode`` (config 5's twin alone, after the tools that
    precede it in phase "tools", or inside the whole ``chip_smoke.main``);
    returns the gates' verdict where the mode runs them."""
    import chip_smoke

    if mode in ("alone", "seeds"):
        chip_smoke.load_tool("bench_config5_real").main(
            ["--views", str(VIEWS), "--device", device, "--json",
             os.path.join(tmp, "t.json")])
        return "ran"
    try:
        if mode == "script":
            chip_smoke.main()
        else:
            from sara_tpu_torch.ops import patch_sampler as ps

            k = [r[0] for r in chip_smoke.TOOL_RUNS].index(
                "bench_config5_real")
            chip_smoke.phase_tools(ps, "witness", device=device,
                                   runs=chip_smoke.TOOL_RUNS[:k + 1])
    except chip_smoke.SmokeFailure as e:
        return f"gate failed: {e}"
    return "every gate passed"


def card_one(mode: str, repeat: int, seeds: list, device: str,
             out: str, capture: str = "") -> None:
    """One card-mode interpreter: ``mode``'s runs, each digest of config
    5's SfM appended to ``out`` as one JSON line (the first run's inputs
    to the later stages saved to ``capture`` where it is given)."""
    import contextlib
    import io
    import tempfile

    plan = ([(None, i) for i in range(repeat)] if mode == "alone"
            else [(s, 0) for s in seeds] if mode == "seeds"
            else [(None, 0)])
    with tempfile.TemporaryDirectory() as tmp:
        for seed, i in plan:
            log = []
            undo = _record_sfm(log, seed, capture)
            t0 = time.perf_counter()
            # The whole script's log is kept beside the digests.
            sink = (open(os.path.join(os.path.dirname(out), "script.log"),
                         "w") if mode == "script" else io.StringIO())
            try:
                with sink, contextlib.redirect_stdout(sink):
                    verdict = _run_mode(mode, device, tmp)
            finally:
                undo()
            for rec in log:
                rec = {"mode": mode, "run": i, "seed": 0 if seed is None
                       else seed, "verdict": verdict,
                       "seconds": round(time.perf_counter() - t0, 1), **rec}
                with open(out, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
                print(json.dumps({k: rec[k] for k in (
                    "mode", "run", "seed", "verdict", "ate",
                    "rot_mean_deg", "sfm_s")}), flush=True)


def card(args) -> None:
    """The card's modes of ``args.modes``, each in a fresh interpreter."""
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "card.jsonl")
    for mode in args.modes.split(","):
        cmd = [sys.executable, str(Path(__file__).resolve()), "card-one",
               "--mode", mode, "--repeat", str(args.repeat), "--seeds",
               args.seeds, "--device", args.device, "--out", out]
        if mode == "alone":
            cmd += ["--capture", os.path.join(args.out, "capture.npz")]
        r = subprocess.run(cmd, text=True, capture_output=True)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            print(f"FAILED {mode}: {r.stderr[-3000:]}", flush=True)
    card_summary(out)


# The digest's fields in pipeline order: the first that differs between
# two runs is the stage where they part.
DIGEST_ORDER = (("kp", "exact"), ("kp", "hash"), ("edges_hash",),
                ("rot_mean_deg",), ("ate_averaged",), ("ate_polished",),
                ("ba",), ("ate",))


def parting_stage(a: dict, b: dict):
    """The first field of ``DIGEST_ORDER`` where runs ``a`` and ``b``
    differ, or None where they are equal throughout."""
    for path in DIGEST_ORDER:
        x, y = a, b
        for key in path:
            x, y = x[key], y[key]
        if x != y:
            return ".".join(path)
    return None


def card_summary(path: str) -> None:
    """Each card run against the first seed-0 run alone: its ATE, gate
    and the first stage where it parts from that run."""
    with open(path) as fh:
        runs = [json.loads(ln) for ln in fh if ln.strip()]
    base = next(r for r in runs if r["mode"] == "alone")
    for r in runs:
        print(json.dumps({"mode": r["mode"], "run": r["run"],
                          "seed": r["seed"], "ate": r["ate"],
                          "above_gate": r["ate"] > GATE,
                          "parts_at": parting_stage(base, r)}))
    for mode in MODES:
        ate = [r["ate"] for r in runs if r["mode"] == mode]
        if ate:
            print(json.dumps({"mode": mode, "n": len(ate),
                              "ate_min_max": [min(ate), max(ate)],
                              "above_gate": int(np.sum(np.asarray(ate)
                                                       > GATE))}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("keypoints")
    k.add_argument("--package", choices=PACKAGES, required=True)
    k.add_argument("--out", required=True)
    s = sub.add_parser("seeds")
    s.add_argument("--package", choices=PACKAGES, required=True)
    s.add_argument("--seeds", required=True, help="comma list")
    s.add_argument("--kps", required=True)
    r = sub.add_parser("run")
    r.add_argument("--packages", default="jax,torch")
    r.add_argument("--seeds", default="0-47", help="first-last")
    r.add_argument("--kps", default="", help="the keypoints' directory")
    r.add_argument("--capture", default="",
                   help="a card run's capture: replay its pair stage, "
                   "the seeds being jitters (0: none)")
    r.add_argument("--workers", type=int, default=6)
    r.add_argument("--out", required=True)
    m = sub.add_parser("summary")
    m.add_argument("paths", nargs="+")
    c = sub.add_parser("card")
    c.add_argument("--repeat", type=int, default=4)
    c.add_argument("--seeds", default="1-8", help="first-last")
    c.add_argument("--device", default="cuda")
    c.add_argument("--modes", default="alone,after_tools,seeds",
                   help=f"comma list of {MODES}")
    c.add_argument("--out", default="chiprun_out/config5")
    o = sub.add_parser("card-one")
    o.add_argument("--mode", choices=MODES, required=True)
    o.add_argument("--repeat", type=int, default=4)
    o.add_argument("--seeds", default="1-8")
    o.add_argument("--device", default="cuda")
    o.add_argument("--out", required=True)
    o.add_argument("--capture", default="")
    rp = sub.add_parser("replay")
    rp.add_argument("--package", choices=PACKAGES, required=True)
    rp.add_argument("--capture", required=True)
    rp.add_argument("--jitters", required=True, help="comma list")
    rp.add_argument("--save-ba", default="",
                    help="save each run's BA problem here (.npz)")
    lj = sub.add_parser("lambda")
    lj.add_argument("--package", choices=PACKAGES, required=True)
    lj.add_argument("--problem", required=True)
    lj.add_argument("--jitters", default="-12-12",
                    help="first-last, e.g. =-12-12 or 0-24")
    lj.add_argument("--key", default="",
                    help="the run of a replay --save-ba file")
    cs = sub.add_parser("card-summary")
    cs.add_argument("path")
    args = ap.parse_args(argv)
    if args.cmd == "keypoints":
        return save_keypoints(args.package, args.out)
    if args.cmd == "seeds":
        return run_seeds(args.package,
                         [int(v) for v in args.seeds.split(",")], args.kps)
    if args.cmd == "run":
        return run_many(args)
    if args.cmd == "summary":
        return summary(args.paths)
    if args.cmd == "card":
        return card(args)
    if args.cmd == "card-one":
        return card_one(args.mode, args.repeat, _seeds(args.seeds),
                        args.device, args.out, args.capture)
    if args.cmd == "replay":
        return replay(args.package, args.capture,
                      [int(v) for v in args.jitters.split(",")],
                      save_ba=args.save_ba)
    if args.cmd == "lambda":
        return lambda_jitter(args.package, args.problem,
                             _seeds(args.jitters), args.key)
    return card_summary(args.path)


if __name__ == "__main__":
    main()
