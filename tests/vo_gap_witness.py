"""Witness of F9: the port's monocular VO against the reference's, as
distributions of ATE over seeds (ROADMAP §3).

Both packages run the A/B VO probe's frames (``tests/ab_vo_witness.py``:
20 renders of the room loop at 240x320, the probes' configuration, the
random source seeded ``1000 + seed``) on the CPU: the port with one torch
thread, the reference WITHOUT x64, as its users run it. Modes:

- ``batched``: ``process_frames``; ``per_frame``: ``process_frame``;
- ``keypoints``: ``process_keypoints`` on the reference's own keypoints of
  every frame (its jitted ``_compute_sift_jit`` at the VO configuration's
  ``SIFTParams``, saved once by the ``keypoints`` command), so both
  packages' back ends see the same detections.

Every run also records its stages per accepted frame: matches, E-RANSAC
inliers and the relative pose's rotation and translation-direction errors
against the render's truth, PnP inliers and pose error before BA,
triangulation candidates and cheirality survivors, and for each BA call
its observations, cameras, points, pinned poses, cost and RMS before and
after, and the window's pose error after it. ``summary`` compares each
stage's per-seed medians across the packages (Mann-Whitney).

    python tests/vo_gap_witness.py keypoints --out D/kps.npz
    python tests/vo_gap_witness.py run --packages jax,torch \\
        --modes batched:0-47,per_frame:0-23 --workers 7 --out D/runs.jsonl
    python tests/vo_gap_witness.py run --packages jax,torch \\
        --modes keypoints:0-47 --kps D/kps.npz --out D/runs.jsonl
    python tests/vo_gap_witness.py summary D/runs.jsonl
    python tests/vo_gap_witness.py one --package torch --mode batched --seed 3

``run`` starts one subprocess per (package, mode, seed), ``--workers`` at
a time, and appends each run's JSON line to ``--out`` (runs already in the
file are skipped, so an interrupted run resumes). One run takes ~1-3 min
on an 8-core CPU, the reference's a little longer than the port's; the
144 runs of the first command take about an hour with 7 workers.
``summary`` prints each seed's ATE and accepted count per package and
mode, both medians and quartiles, the port / reference median ratio with
a bootstrap 95% interval (10,000 resamples, seed 0) and the two-sided
Mann-Whitney p; the gap is real where p < 0.01 and the interval excludes 1.
"""

from __future__ import annotations

import argparse
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

FRAMES, HW = 20, (240, 320)
PACKAGES = ("jax", "torch")
MODES = ("batched", "per_frame", "keypoints")
# Stage metrics, per accepted frame or per BA call, in pipeline order.
STAGES = ("matches", "ransac_inliers", "rel_rot_deg", "rel_tdir_deg",
          "pnp_inliers", "pnp_rot_deg", "pnp_cdir_deg", "tri_candidates",
          "tri_cheiral", "ba_obs", "ba_cams", "ba_points", "ba_pinned",
          "ba_cost0", "ba_cost1", "ba_rms0", "ba_rms1", "ba_window_ate",
          "ba_window_rot_deg")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def _angle_deg(R) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _dir_deg(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    if n < 1e-15:
        return float("nan")
    return float(np.degrees(np.arccos(np.clip(a @ b / n, -1.0, 1.0))))


def _so3_exp(w):
    w = np.asarray(w, float)
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + Wx
    return (np.eye(3) + np.sin(th) / th * Wx
            + (1 - np.cos(th)) / th ** 2 * Wx @ Wx)


def ba_cost(fields, poses, points, delta=4.0, cutoff=6.0):
    """(trimmed Huber cost, RMS pixel residual) of a BA problem's
    observations at ``poses``, ``points``, in float64 (the solvers' cost
    with their default delta and cutoff)."""
    m = fields["obs_mask"].astype(bool)
    ci, pi = fields["cam_idx"][m], fields["pt_idx"][m]
    fx, fy, cx, cy = np.asarray(fields["intrinsics"], float)[:4]
    P = np.asarray(poses, float)
    R = np.stack([_so3_exp(w) for w in P[:, :3]])
    Xc = np.einsum("nij,nj->ni", R[ci], np.asarray(points, float)[pi]) \
        + P[ci, 3:]
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                   fy * Xc[:, 1] / Xc[:, 2] + cy], axis=1)
    n = np.linalg.norm(uv - np.asarray(fields["uv"], float)[m], axis=1)
    c = np.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    c = np.minimum(c, delta * (cutoff * delta - 0.5 * delta))
    return float(c.sum()), float(np.sqrt(np.mean(n * n)))


class Stages:
    """Wraps one pipeline's stage methods (both packages share their names)
    and records each accepted frame's stage numbers against the truth
    (``Rs``, ``cs``: world-to-camera rotations and camera centres)."""

    def __init__(self, pipe, odometry, Rs, cs):
        self.pipe, self.Rs, self.cs = pipe, Rs, cs
        self.frames, self.ba, self.rejected = [], [], 0
        self.cur = None
        for name in ("_integrate", "_prep_pnp", "_prep_triangulation",
                     "_pnp_triangulate", "_estimate_pnp_prepared"):
            setattr(pipe, name, getattr(self, name[1:])(getattr(pipe, name)))
        add = pipe.point_cloud.add_points

        def add_points(track_ids, xyz, colors=None):
            if self.cur is not None:
                self.cur["tri_cheiral"] = (self.cur.get("tri_cheiral", 0)
                                           + len(track_ids))
            return add(track_ids, xyz, colors)

        pipe.point_cloud.add_points = add_points
        self.odometry = odometry
        self._ba = odometry.bundle_adjust
        odometry.bundle_adjust = self.bundle_adjust

    def restore(self):
        self.odometry.bundle_adjust = self._ba

    def _truth(self, f):
        R = np.asarray(self.Rs[f], float)
        return R, -R @ np.asarray(self.cs[f], float)

    def _frame0(self):
        return self.pipe.pose_graph.poses[0].frame_index

    def integrate(self, run):
        def wrapped(kp, m, res, R_rel, t_rel, frame_index):
            mask = _host(m.mask).astype(bool)
            inl = _host(res.inliers).astype(bool) & mask
            prev = self.pipe.pose_graph.poses[-1].frame_index
            Ra, ta = self._truth(prev)
            Rb, tb = self._truth(frame_index)
            R_gt = Rb @ Ra.T
            R = _host(R_rel).astype(float)
            self.cur = {"frame": int(frame_index), "prev": int(prev),
                        "matches": int(mask.sum()),
                        "ransac_inliers": int(inl.sum()),
                        "rel_rot_deg": _angle_deg(R @ R_gt.T),
                        "rel_tdir_deg": _dir_deg(_host(t_rel),
                                                 tb - R_gt @ ta),
                        "tri_candidates": 0, "tri_cheiral": 0}
            ok = run(kp, m, res, R_rel, t_rel, frame_index)
            if ok:
                self.frames.append(self.cur)
            else:
                self.rejected += 1
            self.cur = None
            return ok
        return wrapped

    def prep_pnp(self, run):
        def wrapped(*a):
            prep = run(*a)
            if self.cur is not None:
                self.cur["_pnp_prep"] = prep
            return prep
        return wrapped

    def prep_triangulation(self, run):
        def wrapped(*a):
            prep = run(*a)
            if self.cur is not None and prep is not None:
                self.cur["tri_candidates"] = int(len(prep[0]))
            return prep
        return wrapped

    def _pnp_record(self, got):
        cur = self.cur
        prep = cur.pop("_pnp_prep", None)
        if got is None or prep is None:
            return
        R, t = np.asarray(got[0], float), np.asarray(got[1], float)
        X, _, uv, _, n = prep
        Xc = np.asarray(X[:n], float) @ R.T + t
        K = self.pipe.K
        pix = (Xc @ K.T)[:, :2] / Xc[:, 2:]
        err = np.linalg.norm(pix - np.asarray(uv[:n], float), axis=1)
        cur["pnp_inliers"] = int(np.sum((err < self.pipe.cfg.pnp_threshold_px)
                                        & (Xc[:, 2] > 0)))
        R0 = self._truth(self._frame0())[0]
        Rf = self._truth(cur["frame"])[0]
        cur["pnp_rot_deg"] = _angle_deg(R @ (Rf @ R0.T).T)
        c0 = np.asarray(self.cs[self._frame0()], float)
        cur["pnp_cdir_deg"] = _dir_deg(
            -R.T @ t, R0 @ (np.asarray(self.cs[cur["frame"]], float) - c0))

    def pnp_triangulate(self, run):
        def wrapped(*a):
            got = run(*a)
            if self.cur is not None:
                self._pnp_record(None if got is None else got[:2])
            return got
        return wrapped

    def estimate_pnp_prepared(self, run):
        def wrapped(*a):
            got = run(*a)
            if self.cur is not None:
                self._pnp_record(got)
            return got
        return wrapped

    def bundle_adjust(self, prob, opts):
        out = self._ba(prob, opts)
        f = {k: _host(v) for k, v in prob._asdict().items() if v is not None}
        fixed = f["pose_fixed"].reshape(len(f["poses"]), -1)
        rec = {"ba_obs": int(f["obs_mask"].sum()),
               "ba_points": int((~f["point_fixed"].astype(bool)).sum()),
               "ba_cams": 0, "ba_pinned": 0}
        c0 = ba_cost(f, f["poses"], f["points"])
        c1 = ba_cost(f, _host(out[0].poses), _host(out[0].points))
        rec.update(ba_cost0=c0[0], ba_rms0=c0[1], ba_cost1=c1[0],
                   ba_rms1=c1[1], _fixed=fixed)
        self.ba.append(rec)
        return out

    def bundle_adjust_window(self, run):
        def wrapped(*a, **k):
            n_ba = len(self.ba)
            run(*a, **k)
            if len(self.ba) == n_ba:
                return
            rec = self.ba[-1]
            pg = self.pipe.pose_graph
            w = self.pipe.cfg.ba_window
            C = len(pg) if w == 0 else min(len(pg), w)
            fixed = rec.pop("_fixed")[:C]
            rec["ba_cams"] = int(C)
            rec["ba_pinned"] = int(fixed.all(axis=1).sum())
            vs = range(len(pg) - C, len(pg))
            fi = [pg.poses[v].frame_index for v in vs]
            est = np.stack([-pg.pose(v)[0].T @ pg.pose(v)[1] for v in vs])
            from sara_tpu_torch.utils import ate_rmse

            rec["ba_window_ate"] = float(ate_rmse(
                est, np.asarray([self.cs[i] for i in fi], float)))
            Rs0 = pg.pose(vs[0])[0]
            Rg0 = self._truth(fi[0])[0]
            rec["ba_window_rot_deg"] = max(
                _angle_deg((pg.pose(v)[0] @ Rs0.T) @ (self._truth(i)[0]
                                                      @ Rg0.T).T)
                for v, i in zip(vs, fi))
            rec["frame"] = int(fi[-1])
        return wrapped


def _pipeline(package, K, seed):
    from ab_vo_witness import _config

    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sara_tpu.sfm import OdometryConfig, OdometryPipeline
        from sara_tpu.sfm import odometry

        pipe = OdometryPipeline(K, _config(OdometryConfig, 1.0))
        pipe._key = jax.random.PRNGKey(1000 + seed)
        return pipe, odometry, jax.numpy.asarray
    import torch

    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.sfm import odometry

    pipe = OdometryPipeline(K, _config(OdometryConfig, 1.0), device="cpu")
    pipe._gen.manual_seed(1000 + seed)
    return pipe, odometry, torch.as_tensor


def _keypoint_frames(package, path):
    d = np.load(path)
    fields = [d[f] for f in ("xy", "scale", "orientation", "response",
                             "descriptors", "mask")]
    if package == "jax":
        import jax.numpy as jnp

        from sara_tpu.core.types import Keypoints

        return [Keypoints(*(jnp.asarray(a[f]) for a in fields))
                for f in range(len(fields[0]))]
    from sara_tpu_torch.convert import keypoints_from_numpy

    return [keypoints_from_numpy([a[f] for a in fields], "cpu")
            for f in range(len(fields[0]))]


def run_one(package: str, mode: str, seed: int, kps: str = "") -> dict:
    """One run of ``package`` in ``mode``: its ATE, accepted count and
    stage records."""
    from sara_tpu_torch.utils import ate_rmse
    from torch_probe_batch_parity import render_frames

    K, imgs, Rs, cs = render_frames(FRAMES, HW)
    cs = np.asarray(cs)
    pipe, odometry, put = _pipeline(package, K, seed)
    st = Stages(pipe, odometry, Rs, cs)
    pipe._bundle_adjust = st.bundle_adjust_window(pipe._bundle_adjust)
    t0 = time.perf_counter()
    try:
        if mode == "keypoints":
            ok = [bool(pipe.process_keypoints(kp, f)) for f, kp in
                  enumerate(_keypoint_frames(package, kps))]
        elif mode == "per_frame":
            ok = [bool(pipe.process_frame(put(im), f))
                  for f, im in enumerate(imgs)]
        else:
            ok = [bool(v) for v in pipe.process_frames(
                [put(im) for im in imgs], list(range(len(imgs))))]
    finally:
        st.restore()
    ate = float(ate_rmse(np.asarray(pipe.pose_graph.trajectory()),
                         cs[np.flatnonzero(ok)]))
    return {"package": package, "mode": mode, "seed": seed,
            "accepted": int(sum(ok)), "ate": ate,
            "rejected_attempts": st.rejected, "frames": st.frames,
            "ba": st.ba, "seconds": round(time.perf_counter() - t0, 1)}


def save_keypoints(out: str) -> None:
    """The reference's keypoints of every frame, as ``_fused_frontend``
    computes them (its jitted ``_compute_sift_jit`` at the VO
    configuration's ``SIFTParams``), without x64, into ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sara_tpu.features.api import _compute_sift_jit
    from sara_tpu.sfm import OdometryConfig
    from torch_probe_batch_parity import render_frames

    sift = jax.jit(_compute_sift_jit, static_argnames=("params",))
    _, imgs, _, _ = render_frames(FRAMES, HW)
    kps = [jax.device_get(sift(jnp.asarray(im, jnp.float32),
                               params=OdometryConfig().sift)) for im in imgs]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **{f: np.stack([np.asarray(getattr(k, f)) for k in kps])
                     for f in kps[0]._fields})


def _seeds(spec: str) -> list:
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def _done(path) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        return {(r["package"], r["mode"], r["seed"])
                for r in map(json.loads, filter(str.strip, fh))}


def run_many(args) -> None:
    """Every (package, mode, seed) of ``args`` in its own subprocess,
    ``args.workers`` at a time, each JSON line appended to ``args.out``."""
    jobs = [(p, m, s) for spec in args.modes.split(",")
            for m, _, seeds in [spec.partition(":")]
            for s in _seeds(seeds) for p in args.packages.split(",")]
    done = _done(args.out)
    jobs = [j for j in jobs if j not in done]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    # One thread per run, the reference's XLA too: runs side by side would
    # otherwise oversubscribe the cores.
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               XLA_FLAGS=(env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_"
                          "eigen=false intra_op_parallelism_threads=1"))

    lock = threading.Lock()

    def one(job):
        p, m, s = job
        cmd = [sys.executable, str(Path(__file__).resolve()), "one",
               "--package", p, "--mode", m, "--seed", str(s)]
        if m == "keypoints":
            cmd += ["--kps", args.kps]
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=1800)
        except subprocess.TimeoutExpired:
            r = None
        line = (r.stdout.strip().splitlines()[-1:]
                if r is not None and r.returncode == 0 else [])
        with lock:
            if not line:
                print(f"FAILED {job}: "
                      f"{'timeout' if r is None else r.stderr[-2000:]}",
                      flush=True)
                return
            with open(args.out, "a") as fh:
                fh.write(line[0] + "\n")
            rec = json.loads(line[0])
            print(json.dumps({k: rec[k] for k in (
                "package", "mode", "seed", "accepted", "ate", "seconds")}),
                flush=True)

    with ThreadPoolExecutor(args.workers) as pool:
        list(pool.map(one, jobs))


def bootstrap_class(tdir_deg: float, cheiral: int, matches: int) -> str:
    """The bootstrap pair's (frames 0 -> 1) outcome: "G" within 10 deg of
    the true translation direction, "F" flipped (> 150 deg), "B" the wrong
    motion that leaves many of its triangulated points behind a camera
    (fewer than 80% survive cheirality), "M" anything else."""
    if tdir_deg < 10:
        return "G"
    if tdir_deg > 150:
        return "F"
    return "B" if cheiral < 0.8 * matches else "M"


def _run_class(rec) -> str:
    f1 = [f for f in rec["frames"] if f["frame"] == 1]
    if not f1:
        return "X"
    f1 = f1[0]
    return bootstrap_class(f1["rel_tdir_deg"], f1["tri_cheiral"],
                           f1["matches"])


def bootstrap_draws(kps: str, seeds: list, packages=PACKAGES) -> None:
    """E-RANSAC of both packages at the bootstrap pair (frames 0 -> 1 of
    the reference's keypoints, matched by the reference), as the batched
    pipelines run it there (the fast pass: 128 hypotheses), fed each
    package's draws for seed s: the port's generator seeded 1000 + s, and
    the reference's window key (``PRNGKey(1000 + s)``, split once, then
    into the window's four pair keys, the first pair's). Prints one JSON
    line per seed with the outcome's class under each of ``packages`` and
    each draw, then the counts and, where both packages ran, how often
    they agree on the same draws."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import sara_tpu.ransac.engine as jengine
    import sara_tpu_torch.ransac.engine as tengine
    from sara_tpu.core.types import Keypoints as JKeypoints
    from sara_tpu.matching import MatchParams, match_descriptors
    from sara_tpu.ransac import estimate_relative_pose as jrel
    from sara_tpu_torch.ransac.estimators import \
        estimate_relative_pose as trel
    from torch_probe_batch_parity import render_frames

    K, _, Rs, cs = render_frames(2, HW)
    d = np.load(kps)
    fields = ("xy", "scale", "orientation", "response", "descriptors", "mask")
    a, b = (JKeypoints(*(jnp.asarray(d[f][i]) for f in fields))
            for i in (0, 1))
    m = match_descriptors(a, b, MatchParams(ratio=0.8))
    u, mask = np.asarray(a.xy), np.asarray(m.mask)
    v = np.asarray(b.xy)[np.asarray(m.j)]
    R_gt = np.asarray(Rs[1]) @ np.asarray(Rs[0]).T
    t_gt = -np.asarray(Rs[1]) @ cs[1] + R_gt @ np.asarray(Rs[0]) @ cs[0]
    kw = dict(threshold_px=4.0, num_samples=128, min_inliers=40)

    def classify(R, t):
        """The outcome's class; its cheirality count is the matches whose
        two rays meet in front of both cameras under (R, t)."""
        R, t = np.asarray(R, float), np.asarray(t, float)
        Ki = np.linalg.inv(K)
        ra = np.c_[u[mask], np.ones(mask.sum())] @ Ki.T @ R.T
        rb = np.c_[v[mask], np.ones(mask.sum())] @ Ki.T
        M = np.stack([ra, -rb], axis=-1)                   # (N, 3, 2)
        Mt = M.transpose(0, 2, 1)
        depths = np.linalg.solve(Mt @ M, (Mt @ -t)[..., None])[..., 0]
        front = int(np.sum((depths > 0).all(axis=1)))
        return bootstrap_class(_dir_deg(t, t_gt), front, int(mask.sum()))

    def jax_with(idx, ok):
        jengine.draw_samples = lambda key, ns, k, dm: (idx, ok)
        return jrel(jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(v),
                    jnp.asarray(mask), jnp.asarray(K), jnp.asarray(K), **kw)

    draw = jengine.draw_samples
    run_jax = jax.jit(jax_with)
    T = lambda x: torch.as_tensor(np.array(x, np.float32))
    counts = {}
    for s in seeds:
        g = torch.Generator().manual_seed(1000 + s)
        t_idx, t_ok = tengine.draw_samples(g, 128, 5, torch.as_tensor(mask))
        key = jax.random.split(jax.random.PRNGKey(1000 + s))[1]
        j_idx, j_ok = draw(jax.random.split(key, 4)[0], 128, 5,
                           jnp.asarray(mask))
        row = {"seed": s}
        for src, (idx, ok) in (("port_draws", (t_idx.numpy(), t_ok.numpy())),
                               ("reference_draws", (np.asarray(j_idx),
                                                    np.asarray(j_ok)))):
            got = {}
            if "jax" in packages:
                got["jax"] = run_jax(jnp.asarray(idx, jnp.int32),
                                     jnp.asarray(ok))[1:]
            if "torch" in packages:
                tengine.draw_samples, keep = (
                    lambda *_: (torch.as_tensor(idx).long(),
                                torch.as_tensor(ok))), tengine.draw_samples
                try:
                    got["torch"] = trel(torch.Generator(), T(u), T(v),
                                        torch.as_tensor(mask), T(K), T(K),
                                        **kw)[1:]
                finally:
                    tengine.draw_samples = keep
            for pkg, (R, t) in got.items():
                c = classify(_host(R), _host(t))
                row[f"{pkg}_{src}"] = c
                counts.setdefault(f"{pkg}_{src}", []).append(c)
        print(json.dumps(row), flush=True)
    out = {k: {c: v.count(c) for c in "GMBF"} for k, v in counts.items()}
    if len(packages) == 2:
        out["same_class_on_the_same_draws"] = {
            src: sum(a == b for a, b in zip(counts[f"jax_{src}"],
                                            counts[f"torch_{src}"]))
            for src in ("port_draws", "reference_draws")}
    print(json.dumps(out))


def compare(port, ref, resamples=10_000, seed=0) -> dict:
    """Medians, quartiles, the port / reference median ratio with its
    bootstrap 95% interval and the two-sided Mann-Whitney p of two
    samples; ``real`` is the witness's decision rule (p < 0.01 and the
    interval excludes 1)."""
    from scipy.stats import mannwhitneyu

    port, ref = np.asarray(port, float), np.asarray(ref, float)
    rng = np.random.default_rng(seed)
    bp = np.median(rng.choice(port, (resamples, len(port))), axis=1)
    br = np.median(rng.choice(ref, (resamples, len(ref))), axis=1)
    lo, hi = np.percentile(bp / br, [2.5, 97.5])
    p = float(mannwhitneyu(port, ref, alternative="two-sided").pvalue)
    return {"n": [len(port), len(ref)],
            "median": [float(np.median(port)), float(np.median(ref))],
            "quartiles": [np.percentile(port, [25, 75]).tolist(),
                          np.percentile(ref, [25, 75]).tolist()],
            "ratio": float(np.median(port) / np.median(ref)),
            "ratio_ci95": [float(lo), float(hi)], "p": p,
            "real": bool(p < 0.01 and not lo <= 1.0 <= hi)}


def _stage_medians(rec) -> dict:
    """Per run, the median of each stage metric over its records."""
    out = {}
    for name in STAGES:
        rows = rec["ba"] if name.startswith("ba_") else rec["frames"]
        vals = [r[name] for r in rows if r.get(name) is not None
                and np.isfinite(r[name])]
        if vals:
            out[name] = float(np.median(vals))
    return out


def summary(paths) -> None:
    runs = {}
    for path in paths:
        with open(path) as fh:
            for r in map(json.loads, filter(str.strip, fh)):
                runs[(r["package"], r["mode"], r["seed"])] = r
    for mode in MODES:
        by = {p: {s: r for (q, m, s), r in runs.items()
                  if q == p and m == mode} for p in PACKAGES}
        if not all(by.values()):
            continue
        seeds = sorted(set(by["jax"]) & set(by["torch"]))
        for s in seeds:
            print(json.dumps({"mode": mode, "seed": s, **{
                p: {"ate": round(by[p][s]["ate"], 4),
                    "accepted": by[p][s]["accepted"],
                    "bootstrap": _run_class(by[p][s])} for p in PACKAGES}}))
        ate = {p: [by[p][s]["ate"] for s in seeds] for p in PACKAGES}
        print(json.dumps({"mode": mode, "seeds": [seeds[0], seeds[-1]],
                          "ate": compare(ate["torch"], ate["jax"])}))
        # The bootstrap pair's outcome per package, and the ATE within
        # each outcome.
        cls = {p: [_run_class(by[p][s]) for s in seeds] for p in PACKAGES}
        print(json.dumps({"mode": mode, "bootstrap": {
            p: {c: cls[p].count(c) for c in "GMBFX"} for p in PACKAGES}}))
        for c in "GMBF":
            xs = {p: [a for a, k in zip(ate[p], cls[p]) if k == c]
                  for p in PACKAGES}
            if min(len(v) for v in xs.values()) >= 3:
                r = compare(xs["torch"], xs["jax"], resamples=1000)
                print(json.dumps({"mode": mode, "bootstrap_class": c,
                                  "n": r["n"], "median": r["median"],
                                  "p": r["p"]}))
        med = {p: [_stage_medians(by[p][s]) for s in seeds]
               for p in PACKAGES}
        for name in STAGES:
            xs = {p: [m[name] for m in med[p] if name in m]
                  for p in PACKAGES}
            if min(len(v) for v in xs.values()) < 3:
                continue
            c = compare(xs["torch"], xs["jax"], resamples=1000)
            print(json.dumps({"mode": mode, "stage": name,
                              "median": c["median"], "p": c["p"]}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("keypoints")
    k.add_argument("--out", required=True)
    o = sub.add_parser("one")
    o.add_argument("--package", choices=PACKAGES, required=True)
    o.add_argument("--mode", choices=MODES, default="batched")
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--kps", default="")
    r = sub.add_parser("run")
    r.add_argument("--packages", default="jax,torch")
    r.add_argument("--modes", default="batched:0-47,per_frame:0-23",
                   help="comma list of mode:first-last")
    r.add_argument("--kps", default="")
    r.add_argument("--workers", type=int, default=7)
    r.add_argument("--out", required=True)
    s = sub.add_parser("summary")
    s.add_argument("paths", nargs="+")
    b = sub.add_parser("bootstrap")
    b.add_argument("--kps", required=True)
    b.add_argument("--seeds", default="0-47")
    b.add_argument("--packages", default="jax,torch")
    args = ap.parse_args(argv)
    if args.cmd == "keypoints":
        return save_keypoints(args.out)
    if args.cmd == "bootstrap":
        return bootstrap_draws(args.kps, _seeds(args.seeds),
                               tuple(args.packages.split(",")))
    if args.cmd == "run":
        return run_many(args)
    if args.cmd == "summary":
        return summary(args.paths)
    import torch

    torch.set_num_threads(1)
    print(json.dumps(run_one(args.package, args.mode, args.seed, args.kps)),
          flush=True)


if __name__ == "__main__":
    main()
