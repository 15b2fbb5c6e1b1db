"""Benchmark of the PyTorch / CUDA port: the two-view SIFT frontend
(BASELINE config 1) on one GPU.

Twin of ``bench.py``. It measures the end-to-end detect + describe + match
throughput of ``sara_tpu_torch`` on the bundled image pair (or, without the
reference's photographs, ``bench.py``'s seeded noise pair) and compares it
with OpenCV's CPU SIFT + BF matcher on the same machine, with quality
ratios on a known homography warp and a roofline fraction at the H100's
peaks (``sara_tpu_torch/utils/roofline.py``).

Measurement notes for the card:
- the pairs run through the port's entry points (``compute_sift_keypoints``
  twice, ``match_descriptors``) in a depth-2 pipeline: pair i+1's work is
  launched before pair i's match count is read, as ``bench.py`` does; the
  timed loop starts after a ``torch.cuda.synchronize()``;
- the host syncs of one pair are counted (``set_sync_debug_mode``) and
  logged: where the frontend reads back inside a pair, the pipeline's
  overlap is partial;
- ``SARA_BENCH_BATCH`` > 1 runs each batch as one batched pass, the twin
  of ``bench.py``'s ``jax.vmap``: ``_compute_sift_batch`` on the batch's A
  frames and on its B frames, then one ``_match_sets`` over the pair axis
  (``features/api.py``, ``matching/brute_force.py``), so a batch's
  launches do not grow with its size; its host syncs are counted too.
Without OpenCV there is no baseline:
``vs_baseline`` and the OpenCV ratios are null, and the quality warp is
made by ``warp_homography`` with zeros at the border where OpenCV
reflects.

Prints ONE JSON line on stdout, with ``bench.py``'s keys in its order;
everything else goes to stderr. It imports only ``sara_tpu_torch``, numpy
and ``scripts/torch_eval_detection_quality.py`` (PIL only to read the
photographs, cv2 where present), and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python torch_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sara_tpu_torch.io.datasets import REFERENCE_DATA  # noqa: E402

BATCH = int(os.environ.get("SARA_BENCH_BATCH", "1"))
ITERS = 20 if BATCH == 1 else 5
# Detector capacity operating point (total = 2x per-octave), bench.py's.
TOTAL_CAP = int(os.environ.get("SARA_BENCH_CAPACITY", "8192"))
QUALITY_SCENES = ("sunflowerField.jpg", "dog.jpg", "GuardOnBlonde.tif")
OPENCV_KEYS = ("kp_ratio", "correct_match_ratio", "repeatability_opencv",
               "kp_ratio_min", "correct_match_ratio_min")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _read_gray(path, h, w):
    import PIL.Image

    img = PIL.Image.open(path).convert("L").resize((w, h))
    return np.asarray(img, np.float32) / 255.0


def load_pair(h=480, w=640):
    """The reference's two photographs at (h, w) where both exist, else
    ``bench.py``'s pair: ``RandomState(0)`` noise and the same noise rolled
    16 px along x."""
    paths = [os.path.join(REFERENCE_DATA, n) for n in QUALITY_SCENES[:2]]
    if all(os.path.exists(p) for p in paths):
        try:
            return tuple(_read_gray(p, h, w) for p in paths)
        except Exception as e:
            log(f"photographs unreadable ({e}); the noise pair instead")
    rs = np.random.RandomState(0)
    base = rs.rand(h, w).astype(np.float32)
    return base, np.roll(base, 16, axis=1)


def probe_frames(n=1, h=480, w=640):
    """(frames, source): ``n`` <= 2 gray frames in [0, 1] at (h, w) for
    the probes' twins, the reference's photographs (``QUALITY_SCENES``'
    first ``n``) where they exist, else renders of ``tests/render3d.py``'s
    ``make_room(seed=1)`` from the room loop (positions 0 and 5 of its 100,
    ``scripts/probe_ab_vo.py``'s path), and the name of that source."""
    paths = [os.path.join(REFERENCE_DATA, m) for m in QUALITY_SCENES[:n]]
    if all(os.path.exists(p) for p in paths):
        try:
            return ([_read_gray(p, h, w) for p in paths],
                    "photographs " + ", ".join(QUALITY_SCENES[:n]))
        except Exception as e:
            log(f"photographs unreadable ({e}); the rendered room instead")
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from render3d import make_room, render

    planes = make_room(seed=1)
    K = np.array([[0.94 * w, 0, w / 2], [0, 0.94 * w, h / 2], [0, 0, 1.0]])
    frames = []
    for i in range(0, 5 * n, 5):
        a = 2 * np.pi * i / 100.0
        c = np.array([0.5 + 1.6 * np.sin(a), 0.0,
                      4.0 + 1.6 * (1 - np.cos(a))])
        yaw = 0.25 * np.sin(a)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        with np.errstate(invalid="ignore", divide="ignore"):
            frames.append(np.asarray(render(planes, K, R, -R @ c,
                                            hw=(h, w)), np.float32))
    return frames, f"make_room(seed=1) rendered at {h}x{w}"


def quality_tool():
    """``scripts/torch_eval_detection_quality.py``, loaded by path."""
    path = os.path.join(ROOT, "scripts", "torch_eval_detection_quality.py")
    spec = importlib.util.spec_from_file_location(
        "torch_eval_detection_quality", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def warp_without_cv2(img, H, device=None):
    """``img`` warped by the homography ``H`` (maps source to destination
    pixels) on ``device`` by the port's ``warp_homography``, zeros outside
    the source: the quality warp where OpenCV is absent. The tool's
    ``cv2.warpPerspective`` reflects at the border instead."""
    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.image.transform import warp_homography

    h, w = img.shape
    img = torch.as_tensor(img).to(resolve_device(device), torch.float32)
    return warp_homography(img, np.linalg.inv(H), h, w, fill_value=0.0)


def quality_vs_opencv(img, device=None):
    """Detection / matching quality on known-homography warps: the port's
    frontend (the quality tool's ``run_ours``) against OpenCV's SIFT on
    the same task, over the scenes of ``QUALITY_SCENES`` that exist (the
    pair's first image stands for the primary one). Returns the primary
    scene's ratios and the worst ratios across scenes; >= 1.0 beats
    OpenCV. Without cv2 the OpenCV ratios are None and the warp is
    :func:`warp_without_cv2`'s."""
    q = quality_tool()
    try:
        import cv2  # noqa: F401
        have_cv = True
    except ImportError:
        have_cv = False
    log("quality warp: " + ("cv2.warpPerspective (border reflected)"
                            if have_cv else "warp_homography on the device "
                            "(zeros at the border; no cv2, no OpenCV "
                            "baseline)"))

    def eval_scene(im):
        h, w = im.shape
        H = q.make_warp(h, w)
        warped = (q.warp_image(im, H) if have_cv
                  else warp_without_cv2(im, H, device))
        ours = q.score(q.run_ours(im, warped, -1, TOTAL_CAP,
                                  TOTAL_CAP // 2, device=device), H, h, w)
        out = {"kp_ratio": None, "correct_match_ratio": None,
               "repeatability": ours["repeatability"],
               "repeatability_opencv": None}
        if have_cv:
            cv = q.score(q.run_opencv(im, warped), H, h, w)
            out.update(kp_ratio=ours["kp"][0] / max(cv["kp"][0], 1),
                       correct_match_ratio=ours["correct"] / max(
                           cv["correct"], 1),
                       repeatability_opencv=cv["repeatability"])
        return out

    scenes = {"primary": img}
    for name in QUALITY_SCENES[1:]:
        path = os.path.join(REFERENCE_DATA, name)
        if not os.path.exists(path):
            log(f"scene {name} unavailable: no file {path}")
            continue
        try:
            scenes[name] = _read_gray(path, 480, 640)
        except Exception as e:
            log(f"scene {name} unavailable: {e}")

    def fmt(v):
        return "null" if v is None else f"{v:.3f}"

    results = {}
    for name, im in scenes.items():
        results[name] = r = eval_scene(im)
        log(f"quality[{name}]: kp_ratio {fmt(r['kp_ratio'])} correct "
            f"{fmt(r['correct_match_ratio'])} rep {fmt(r['repeatability'])} "
            f"vs cv {fmt(r['repeatability_opencv'])}")

    def rounded(v):
        return None if v is None else round(v, 3)

    def worst(key):
        vals = [r[key] for r in results.values()]
        return None if None in vals else min(vals)

    pri = results["primary"]
    return {
        "kp_ratio": rounded(pri["kp_ratio"]),
        "correct_match_ratio": rounded(pri["correct_match_ratio"]),
        "repeatability": rounded(pri["repeatability"]),
        "repeatability_opencv": rounded(pri["repeatability_opencv"]),
        "kp_ratio_min": rounded(worst("kp_ratio")),
        "correct_match_ratio_min": rounded(worst("correct_match_ratio")),
        "quality_scenes": len(results),
    }


def bench_ours(a, b, device=None, record=None):
    """Frames per second of the port's frontend + matcher on the pair
    (a, b), depth-2 pipelined over ``ITERS`` batches of ``BATCH`` pairs
    (a batch of more than one pair is one batched pass);
    returns (frames/s, keypoints of a, matches) of the warm-up pair. A
    dict ``record`` receives what the run saw besides: the keypoint and
    match counts of the warm-up pair, the match counts of the first batch
    and of every pipelined one, ms per batch, the batch size, the host
    syncs of one pair and of one batch, and the sampler kernels'
    launches."""
    import dataclasses

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.features.api import _compute_sift_batch
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.matching.brute_force import _match_sets
    from sara_tpu_torch.ops import patch_sampler as ps
    from sara_tpu_torch.utils.timing import count_syncs

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    params = SIFTParams()
    if TOTAL_CAP != params.total_capacity:
        params = dataclasses.replace(
            params, total_capacity=TOTAL_CAP,
            dog=dataclasses.replace(params.dog, capacity=TOTAL_CAP // 2))
    mp = MatchParams(ratio=0.8)
    launches0 = ps.counts()

    # --- single-pair reference run (keypoint / match counts). ---
    t0 = time.perf_counter()
    ka = compute_sift_keypoints(a, params, device=dev)
    kb = compute_sift_keypoints(b, params, device=dev)
    m = match_descriptors(ka, kb, mp, device=dev)
    n_a, n_b, n_m = int(ka.count()), int(kb.count()), int(m.count())
    log(f"single pair first run: {time.perf_counter()-t0:.1f}s; "
        f"kp {n_a}/{n_b}, matches {n_m}")

    def one(ia, ib):
        xa = compute_sift_keypoints(ia, params, device=dev)
        xb = compute_sift_keypoints(ib, params, device=dev)
        return match_descriptors(xa, xb, mp, device=dev).count()

    def batched(imgs_a, imgs_b):
        if BATCH == 1:
            return one(imgs_a[0], imgs_b[0])
        # One batched pass per side and one batched matching, as bench.py
        # vmaps ``one`` over the batch.
        xa = _compute_sift_batch(imgs_a, params, device=dev)
        xb = _compute_sift_batch(imgs_b, params, device=dev)
        _, ok, _ = _match_sets(xa.descriptors, xa.mask, xb.descriptors,
                               xb.mask, mp.ratio, mp.mutual)
        return ok.sum(dim=-1)

    rs = np.random.RandomState(0)
    batch_a = torch.as_tensor(np.stack(
        [a + rs.normal(scale=1e-4, size=a.shape).astype(np.float32)
         for _ in range(BATCH)])).to(dev)
    batch_b = torch.as_tensor(np.stack(
        [b + rs.normal(scale=1e-4, size=b.shape).astype(np.float32)
         for _ in range(BATCH)])).to(dev)
    t0 = time.perf_counter()
    first = batched(batch_a, batch_b).cpu().numpy()
    log(f"batched first: {time.perf_counter()-t0:.1f}s "
        f"(counts {first.tolist()})")
    if on_card:
        syncs = count_syncs(lambda: one(batch_a[0], batch_b[0]))
        log(f"host syncs per pair: {syncs['syncs']} at {syncs['at']}"
            + (" (the frontend reads back inside a pair, so the pipeline "
               "overlaps the next pair's launches only after the last of "
               "them)" if syncs["syncs"] else ""))
        batch_syncs = (count_syncs(lambda: batched(batch_a, batch_b))
                       if BATCH > 1 else syncs)
        log(f"host syncs per batch of {BATCH}: {batch_syncs['syncs']}")
    else:
        syncs = batch_syncs = {"syncs": None,
                               "at": "not measured on the CPU"}

    # Depth-2 pipeline: launch batch i+1 before reading batch i's counts.
    seen = []
    sync()
    t0 = time.perf_counter()
    pending = batched(batch_a, batch_b)
    for _ in range(ITERS - 1):
        nxt = batched(batch_a, batch_b)
        seen.append(pending.cpu().numpy())
        pending = nxt
    seen.append(pending.cpu().numpy())
    dt = (time.perf_counter() - t0) / ITERS
    fps = 2.0 * BATCH / dt
    launches = {k: v - launches0[k] for k, v in ps.counts().items()}
    log(f"sara-tpu-torch pipelined: {dt*1e3:.1f} ms / {BATCH} pairs "
        f"-> {fps:.2f} frames/s; sampler launches {launches}")
    if record is not None:
        record.update(keypoints=[n_a, n_b], matches=n_m,
                      first_counts=first.tolist(),
                      pipelined_counts=[c.tolist() for c in seen],
                      ms_per_batch=dt * 1e3, syncs_per_pair=syncs["syncs"],
                      syncs_at=syncs["at"],
                      syncs_per_batch=batch_syncs["syncs"], batch=BATCH,
                      sampler_launches=launches)
    return fps, n_a, n_m


def bench_opencv(a, b, iters=5):
    import cv2

    a8 = (a * 255).astype(np.uint8)
    b8 = (b * 255).astype(np.uint8)
    sift = cv2.SIFT_create()
    bf = cv2.BFMatcher()

    def run():
        ka, da = sift.detectAndCompute(a8, None)
        kb, db = sift.detectAndCompute(b8, None)
        matches = bf.knnMatch(da, db, k=2)
        good = [m for m, n in matches if m.distance < 0.8 * n.distance]
        return len(ka), len(kb), len(good)

    run()  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        na, nb, nm = run()
    dt = (time.perf_counter() - t0) / iters
    log(f"opencv: kp {na}/{nb}, matches {nm}, {2.0/dt:.2f} frames/s")
    return 2.0 / dt


def roofline(fps, h, w):
    """The roofline keys at the H100's peaks: one frame's estimate (SIFT
    at ``TOTAL_CAP`` keypoints plus half of the pair's matching GEMM, the
    measured time being per frame) against 1 / ``fps``."""
    from sara_tpu_torch.utils.roofline import Estimate, match_pair, sift_frame

    cap = TOTAL_CAP
    sift_est = sift_frame(h, w, first_octave=-1, keypoints=cap)
    m_est = match_pair(cap, cap)
    est = Estimate(sift_est.flops + 0.5 * m_est.flops,
                   sift_est.bytes + 0.5 * m_est.bytes)
    return {
        "frame_gflop": round(est.flops / 1e9, 2),
        "frame_mb": round(est.bytes / 1e6, 1),
        "roofline_frac": round(est.achieved_fraction(1.0 / fps), 4),
        "roofline_bound": est.bound(),
    }


def main(argv=None, record=None):
    """The benchmark (``record``: see :func:`bench_ours`); prints and
    returns its line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    a, b = load_pair()
    ours_fps, n_kp, n_m = bench_ours(a, b, device=dev, record=record)
    try:
        cv_fps = bench_opencv(a, b)
    except Exception as e:
        log("opencv baseline failed:", e)
        cv_fps = float("nan")
    try:
        quality = quality_vs_opencv(a, device=dev)
    except Exception as e:
        log("quality gate failed:", e)
        quality = {}
    # No baseline without OpenCV: null, never 1.0 (which reads as parity).
    vs = round(ours_fps / cv_fps, 3) if cv_fps == cv_fps else None
    try:
        roof = roofline(ours_fps, *a.shape)
    except Exception as e:
        log("roofline failed:", e)
        roof = {}
    result = {
        "metric": "two_view_sift_detect_describe_match_throughput",
        "value": round(ours_fps, 3),
        "unit": "frames/s",
        "vs_baseline": vs,
        **quality,
        **roof,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
