#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sara_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or ``sara_tpu``. Phases (a failure in any of them
raises, so the script exits nonzero and prints no result line):

1. require a CUDA device; print the card's name and power limit;
2. build every CUDA kernel of the main path from the sources in
   ``sara_tpu_torch/ops/csrc`` (one nvcc process each, all at once);
3. hold each kernel (K1, and K2 = the x-packed mode), in both its variants
   (vector and general), against its plain PyTorch version on the card, at
   the main path's shapes and on the edge cases (last row and column, odd
   and even x0, int32 and int64 indices, C = 37 and a misaligned base,
   which take the general variant; NaN coordinates, vector against
   general), max abs error <= 1e-5, checking by the counters which variant
   the wrapper took;
4. drive the frame path through the entry points a user calls: two 480x640
   frames (B is A shifted 16 px) through ``compute_sift_keypoints`` with the
   bilinear kernel-sampler configuration, then ``match_descriptors``. The
   launch counts are set to 0 just before and read just after (12 launches
   of K1's vector variant, no other kernel, no index copy); then check the
   keypoints, the 16-px shift of the matches, and that the gather sampler
   gives the same keypoints and descriptors;
5. drive K2's path: frame A's six sampler launches again through
   ``sample_field_patches(..., pack_x=True)`` (counts set to 0 just before,
   read just after: octaves 0-4 take K2, octave 5 takes K1, all in the
   vector variant), each output held to K2's plain version and to K1's
   output;
6. time each kernel on the inputs the main path gave it: the vector
   variant and the general variant (the first Hopper kernel) in turns
   (general, vector, vector, general), the plain version, a PyTorch library
   call, an empty one-block kernel (the launch floor) and a contiguous copy
   of as many bytes as the kernel requests, beside the card's bound for
   that work;
7. drive the two-view path (Slice B) at full size: ``estimate_homography``
   on the frame pair's matches, and ``estimate_relative_pose``,
   ``estimate_fundamental`` and ``estimate_absolute_pose`` on a synthetic
   scene of 8192 slots (4096 valid correspondences, 30% outliers); check
   the recovered geometry, time each estimator and profile one relative
   pose;
8. phase "vo" (Slice C): 30 renders of ``tests/render3d.py``'s room at
   480x640 on ``scripts/eval_vo.py``'s loop and configuration through
   ``OdometryPipeline`` (frames 0-11 by ``process_frame``, 12-29 by
   ``process_frames``, whose windows of 4 go through the batched frontend),
   the sampler counts set to 0 just before and read just after: at least
   29 accepted, ATE <= 0.10, > 500 map points, K1's vector variant once per
   octave of every frame of ``process_frame`` and of every window, the
   native union-find; records ms per frame and per stage, BA ms per call,
   host syncs and a profile;
9. phase "ba": ``scripts/bench_ba.py``'s "large" problem (C=256,
   P=100,000, O=800,000, float32) through ``bundle_adjust`` (dense Schur),
   a ``DenseSchurSession`` solved twice and ``bundle_adjust_cg``, 10 LM
   iterations each: every cost falls, dense and CG within 1%, the session
   continues; records ms per LM iteration, syncs, peak memory, a profile;
10. phase "loop" (Slice D1 + D3): BASELINE config 3 as ``scripts/eval_vo.py
   --room --frames 100 --loop`` runs it, 100 renders of the same room at
   240x320 on the whole loop through ``process_frame`` with a
   ``LoopCloser`` on the ``on_accept`` hook, then ``close``; gates: >= 99
   accepted, a verified metric loop edge, ATE after <= 1.05 x before +
   1e-6 and <= 1.25 x the largest of the reference's own nine runs on
   these frames (``LOOP_ATE_GATE``), finite graph and map, K1's vector variant on every frame, the
   native union-find, and a checkpoint round trip (``save_sfm_state`` /
   ``load_sfm_state``) into a fresh pipeline on the card; records ms per
   frame, ATE, the loop edges, the Sim(3) scale drift, ``close``'s ms,
   syncs and profile;
11. phase "global_sfm" (Slice D1): ``scripts/bench_sfm_scale.py``'s ring
   scene (128 views, 900 points, capacity 512, 502 pairs) through
   ``run_global_sfm`` (chunks of 32 pairs, 256 hypotheses, BA 40
   iterations); gates: >= 127 edges, ATE <= 0.15, > 500 points, the BA cost
   falls, finite output; records stage seconds, pairs/s, views/s, one
   relative pose's syncs and a profile of stages 3-6;
12. phase "low_precision" (after step 6): the frontend with bfloat16
   orientation maps at stride 2 against float32 at stride 1 on the frame
   pair (ms, device busy, K1's launches and ms, match recall), each K1
   output of the counted run held against the plain version;
13. phase "city" (Slice D2, BASELINE config 5's BA): the 1024-view city
   scene's true tracks (C=1024, 5,885 points, 393,167 observations,
   float32) through ``partitioned_bundle_adjust`` (16 blocks, 2 sweeps, 12
   LM iterations) and the global CG ``bundle_adjust`` (36 iterations):
   both lower the cost, the partitioned cost <= the initial, finite;
   records the cost ratio, Cb, Pb, Sp, seconds per phase, syncs, peak
   memory; then ``run_global_sfm`` on 256 of its views with ``ba_blocks=8``
   on a "block" mesh: >= views - 1 edges, ATE < 2.0, > 500 points;
14. phase "dist" (Slice D2): a world of one under NCCL: the sharded
   dense-Schur solver (phase "ba"'s problem) and the CG solver on
   observation shards equal their single-device runs within 1e-5, the
   meshed partitioned solve equals phase "city"'s within 1e-6, batched
   matching of 8 pairs equals ``match_descriptors``; records the
   all-reduce ms of one LM iteration's payload;
15. phase "calib" (Slice E, camera calibration as
   ``python -m sara_tpu_torch.calib.cli`` runs it): 20 rendered 1280x720
   views of a 6x9-inner-corner board (K = 1000, 1000, 640, 360; yaw and
   pitch over +-35 degrees) through the CLI's ``collect_views`` and
   ``calibrate_views``; gates: 20/20 grids, corners within 0.3 px, fx and
   fy within 0.5%, cx and cy within 2 px, RMS < 0.1 px, float32 against
   float64, a barrel-warped view through the squares fallback within 0.7
   px, ``calibrate_omnidirectional`` recovering xi = 0.8 within 0.1, one
   view's device program on the card equal to the CPU's; records ms per
   view and its split, the LM's ms, syncs and a profile;
16. phase "detect_track" (Slice F, YOLO detection and tracking): the
   yolov4-tiny architecture of ``tests/darknet_cfgs.py`` (random weights,
   seed 3) at 416x416x3 on batches of 1 and 8 through ``darknet_forward``,
   ``yolo_decode`` and ``nms_boxes``, a seeded 300-frame stream of up to
   40 boxes through ``MultiObjectTracker``, and 30 frames of the
   detector's own output through the tracker; gates: the head shapes, the
   card's heads and NMS picks equal the CPU's, every long-lived object
   confirmed with no identity switch, the card's track IDs the CPU's;
   records forward ms and TFLOP/s, decode + NMS ms, tracker ms and syncs
   per step, a profile and peak memory;
17. phase "propagation" (Slice F, the feature and matching extras): on the
   frame pair's keypoints and matches (no new frontend run),
   ``propagate_matches`` at the full 8192-slot capacity, the LoG, DoH and
   Harris-Laplace detectors, affine shapes, dense SIFT, NCC and
   self-matching; gates: densified matches on the shift, NCC recovering
   the shift, and every output equal to the CPU's on the same inputs;
   records ms per call and the sweeps' device time;
18. phase "e3" (the last image and contour modules) at 480x640 on frame A
   of the frame pair: ``deriche_blur``, ``otsu_threshold``,
   ``adaptive_threshold``, ``label_connected_components`` on the Otsu
   mask, ``watershed`` from grid markers, ``slic``, ``gemm_conv2d`` (7x7),
   ``signed_distance`` of a disc of radius 100, a 50-step ``NarrowBand``
   curvature flow and ``suzuki_abe_borders`` on the card's CCL mask; gates:
   each result equals the port's CPU run on the same inputs (labels and
   contours exactly, SLIC's labels for >= 99.9% of pixels with centres
   within 1e-3 px, the float maps within 1e-5 relative or 1e-4); records
   ms, device operations, busy / idle and syncs of each function (the
   flow's profile is cut for time: its ms and syncs stay);
19. phase "demos" (the demo twins ``examples/torch_*.py``): the six demos
   through their ``main``, on the card, at their default widths (20
   synthetic VO frames, 8 SfM views), each gated on its result against the
   synthetic truth (the 16-px shift, the inlier shares, the homography's
   corners, the rotation, the BA's RMS, the VO's ATE; the SfM's edges and
   the ATE of the float64 solution of its own BA problem, its float32 ATE
   logged: ROADMAP §3, F6);
20. phase "tools" (the twins ``scripts/torch_*.py`` of the command-line
   tools): ``eval_vo`` (synthetic keypoints; the room loop pipelined with
   closure), ``bench_vo_frontend``, ``bench_ba``, ``bench_sfm_scale``,
   ``bench_city_scale``, ``bench_config5_real``, ``eval_real_images`` and
   ``mc_fivepoint`` through their ``main(argv)`` on the card, each at a
   size cut from its default (``TOOL_RUNS``, printed beside each run) and
   gated on what its tool reports (``tool_failures``), and
   ``eval_detection_quality``'s ``run_ours`` at the tool's defaults on a
   texture and its warp made on the card, without its OpenCV baseline
   (``detection_quality``; gates: >= 95% of matches correct, repeatability
   >= ``QUALITY_REPEATABILITY_FLOOR``, 8 K1 launches); the sampler counts
   are set to 0 just before each run and read just after (K1's vector
   variant on the runs that detect SIFT on pixels, nothing on the others);
21. phase "bench": the bench twin ``torch_bench.py`` (the headline metric,
   ``two_view_sift_detect_describe_match_throughput`` in frames/s) through
   its ``main`` at its defaults (480x640, capacity 8192, 20 pipelined
   pairs); gates: one JSON line with the metric and a finite positive
   value, the pipelined counts equal to the first batch's, no sampler
   launch on the throughput path (the "gather" sampler), the quality run's
   K1 launches, null OpenCV ratios without cv2, a roofline fraction below
   1.05 (``phase_bench``);
22. phase "probes": the 21 probe twins ``scripts/torch_probe_*.py``
   through their ``main(argv)`` at the probes' defaults or a printed cut
   (``PROBE_RUNS``): the frontend's stage prefixes and trace, K1 against
   row gathers, the VO stages, the BA pieces, the dense-Schur passes and
   pass A's sub-stages with the S contraction's TFLOP/s, the segment sums,
   the batch probes, the global SfM's and the city's stage errors, the
   dense-Schur ablation and its camera-column lowerings, the descriptor
   internals, the frontend sweep, the tracker's growth, the capacity
   program and the fault probes' prefixes; gates: every stage printed in
   order, K1 against the bilinear gather, the segment sums' errors, the
   dense pieces composed equal to one solver iteration, the lowerings
   within float32 rounding, the capacity probe's assert, the descriptors
   whole and in sections equal (``phase_probes``); the sampler counts set
   to 0 just before each twin and read just after;
23. phase "batch" (the batched frontend): windows of B = 1, 4 and 8
   480x640 frames (the frame pair, then renders of the room loop) through
   ``_compute_sift_batch`` with the kernel sampler and one batched
   ``_match_sets``, VO's ``_fused_frontend_batch`` on the room frames, and
   ``torch_bench.main`` at ``SARA_BENCH_BATCH`` = 4; gates: one K1 launch
   per octave per window whatever B (counted from 0 just before one window
   and read just after), each K1 output of the 8-frame window (the
   frame-folded field) within 1e-5 of the plain version, every frame's
   keypoints and match sets against the frame alone, 0 host syncs in
   detection and matching, B = 8's device operations at most 1.2 x B = 1's,
   the bench line (``phase_batch``); records ms per window, frames/s, peak
   memory and syncs per B;
24. print the kernels line, the card line, then the result line.
Each phase logs its seconds.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
TOLERANCE = 1e-5             # kernel vs plain version, max abs error
SHIFT_PX = 16
FRAME_HW = (480, 640)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print("[chip_smoke]", *args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def texture(seed: int, h: int, w: int) -> np.ndarray:
    """Blurred multi-octave noise in [0.1, 0.9] (FFT Gaussian blurs)."""
    rs = np.random.RandomState(seed)
    f2 = (np.fft.fftfreq(h)[:, None] ** 2 + np.fft.rfftfreq(w)[None, :] ** 2)
    out = np.zeros((h, w))
    for sigma, weight in ((1.5, 0.4), (4.0, 0.35), (12.0, 0.25)):
        spec = np.fft.rfft2(rs.rand(h, w)) * np.exp(
            -2.0 * math.pi ** 2 * sigma ** 2 * f2)
        out += weight * np.fft.irfft2(spec, s=(h, w))
    out = (out - out.min()) / (out.max() - out.min())
    return (0.1 + 0.8 * out).astype(np.float32)


def timed_ms(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` over ``reps`` launches, by CUDA events,
    with the L2 cache flushed (a 256 MB write) before each launch."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def sampler_problem(g: torch.Generator, S, H, W, K, N=16, C=36, rad=25.7,
                    edge=False, dtype=torch.float32, index=torch.int64,
                    pins=False, misaligned=False, nan=False):
    """Sampler inputs on the card. ``edge``: centres pinned to the border;
    ``pins``: samples exactly on the last row and column and at odd and
    even x0; ``misaligned``: maps at a base one element past an aligned
    one; ``nan``: some NaN coordinates."""
    dev = torch.device("cuda")
    maps = torch.rand((S, H, W, C), generator=g, device=dev).to(dtype)
    if misaligned:
        flat = torch.empty(maps.numel() + 1, dtype=dtype, device=dev)
        maps = flat[1:].view(maps.shape).copy_(maps)
    if edge:
        pins_y = torch.tensor([0.0, 1.0, H - 2.0, H - 1.0], device=dev)
        pins_x = torch.tensor([0.0, 1.0, W - 2.0, W - 1.0], device=dev)
        cy = pins_y[torch.randint(0, 4, (K,), generator=g, device=dev)]
        cx = pins_x[torch.randint(0, 4, (K,), generator=g, device=dev)]
    else:
        cy = torch.rand((K,), generator=g, device=dev) * (H - 1)
        cx = torch.rand((K,), generator=g, device=dev) * (W - 1)
    spread = lambda: (torch.rand((K, N), generator=g, device=dev) * 2 - 1) * rad
    ys = (cy[:, None] + spread()).contiguous()
    xs = (cx[:, None] + spread()).contiguous()
    if pins:
        ys[:, :4] = H - 1.0                   # y exactly on the last row
        xs[:, 4:8] = W - 1.0                  # x exactly on the last column
        xs[:, 8] = W - 1.5                    # even x0 = W - 2
        xs[:, 9] = W - 2.5                    # odd x0 = W - 3
        xs[:, 10:16] = 20.0 + 0.75 * torch.arange(6, device=dev)
    if nan:
        ys[::3, 0] = float("nan")
        xs[::2, 1] = float("nan")
        ys[1::4, 2] = xs[1::4, 2] = float("nan")
    si = torch.randint(0, S, (K,), generator=g, device=dev).to(index)
    return maps, si, ys, xs


def variant_counts(ps) -> dict:
    return {k: v for k, v in ps.counts().items() if k != "index copies"}


def phase_kernels_vs_plain(ps) -> dict:
    """K1 and K2, each in both variants, against their plain versions: the
    main path's octave-0 shape (random and edge-pinned centres, f32 and
    bf16), a ragged K = 13, the octave-5 shape, an int32 index, samples on
    the last row and column and at odd and even x0; C = 37 and a
    misaligned base, which the wrapper sends to the general variant; and
    NaN coordinates, vector against general (the plain version has no
    answer there). Returns the worst error of each (kernel, variant)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    octave0 = dict(S=5, H=960, W=1280, K=5120)
    small = dict(S=5, H=120, W=160, K=256)
    cases = [("octave0", octave0),
             ("octave0 edge", dict(octave0, edge=True)),
             ("octave0 bf16", dict(octave0, dtype=torch.bfloat16)),
             ("K=13", dict(S=5, H=120, W=160, K=13)),
             ("octave5", dict(S=5, H=30, W=40, K=80)),
             ("int32 index", dict(S=5, H=480, W=640, K=3750,
                                  index=torch.int32)),
             ("last row/column, odd/even x0", dict(small, pins=True)),
             ("C=37", dict(small, C=37)),
             ("misaligned", dict(small, misaligned=True)),
             ("bf16 misaligned", dict(small, misaligned=True,
                                      dtype=torch.bfloat16))]
    worst = {(k, v): 0.0 for k in ("K1", "K2") for v in ("vector", "general")}
    for packed in (False, True):
        kname = "K2" if packed else "K1"
        plain = (ps._sample_patches_packed_reference if packed
                 else ps._sample_patches_reference)
        for name, kw in cases:
            if packed and not ps.packed_layout_ok((1, 1, kw["W"], 36)):
                continue
            maps, si, ys, xs = sampler_problem(g, **kw)
            vector = ps.vector_layout_ok(maps)
            check(vector == (name not in ("C=37", "misaligned",
                                          "bf16 misaligned")),
                  f"{name}: vector_layout_ok is {vector}")
            ref = plain(maps, si, ys, xs)
            before = variant_counts(ps)
            outs = {"vector" if vector else "general":
                    ps.sample_field_patches(maps, si, ys, xs,
                                            max_sample_radius=25.7,
                                            pack_x=packed)}
            torch.cuda.synchronize()
            after = variant_counts(ps)
            moved = [k for k in after if after[k] != before[k]]
            want = kname + ("" if vector else " general")
            check(moved == [want] and after[want] == before[want] + 1,
                  f"{kname} {name}: launched {moved}, expected {want}")
            if vector:
                outs["general"] = ps._launch(maps, si, ys, xs, packed=packed,
                                             vector=False)
            for variant, out in outs.items():
                check(out.shape == ref.shape,
                      f"{name}: shape {tuple(out.shape)}")
                err = (out - ref).abs().max().item()
                log(f"{kname} {variant} vs plain [{name}] "
                    f"{tuple(maps.shape)} {str(maps.dtype)[6:]} "
                    f"{str(si.dtype)[6:]} K={ys.shape[0]}: "
                    f"max_abs_err={err:.3e}")
                check(err <= TOLERANCE, f"{kname} {variant} {name}: {err}")
                worst[kname, variant] = max(worst[kname, variant], err)
        maps, si, ys, xs = sampler_problem(g, **small, nan=True)
        new = ps._launch(maps, si, ys, xs, packed=packed, vector=True)
        old = ps._launch(maps, si, ys, xs, packed=packed, vector=False)
        torch.cuda.synchronize()
        err = (new - old).abs().max().item()
        log(f"{kname} vector vs general [NaN coordinates]: "
            f"max_abs_err={err:.3e}")
        check(bool(torch.isfinite(new).all()) and err <= TOLERANCE,
              f"{kname} NaN coordinates: vector vs general {err}")
    return worst


def sampler_library_call(maps, s_idx, ys, xs):
    """One PyTorch call computing the sampler's function (the yardstick,
    never called by the port): 3-D grid_sample over the (1, C, S, H, W)
    view with align_corners=True and border padding; integer z reduces the
    trilinear weights to bilinear within the slice."""
    S, H, W, C = maps.shape
    inp = maps.permute(3, 0, 1, 2).unsqueeze(0)
    gz = (s_idx.float() * (2.0 / max(S - 1, 1)) - 1.0)[:, None].expand_as(xs)
    grid = torch.stack([xs * (2.0 / (W - 1)) - 1.0,
                        ys * (2.0 / (H - 1)) - 1.0, gz], dim=-1)
    grid = grid[None, :, :, None, :].contiguous()

    def call():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return call, lambda out: out[0, :, :, :, 0].permute(1, 2, 0)


def sampler_bound_ms(maps, s_idx, ys, xs) -> tuple[float, str]:
    """Least time for this call's work on an H100: bytes (outputs written
    once, coordinates and indices read once, each distinct tap row read
    once) over the memory rate, or flops (13 per output: two weight
    complements, eight products, three sums) over the f32 rate."""
    S, H, W, C = maps.shape
    K, N = ys.shape
    s = s_idx.long().clamp(0, S - 1)[:, None]
    yc = ys.clamp(0, H - 1)
    xc = xs.clamp(0, W - 1)
    y0, x0 = yc.floor().long(), xc.floor().long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    rows = torch.cat([(s * H + yy) * W + xx for yy, xx in
                      ((y0, x0), (y0, x1), (y1, x0), (y1, x1))])
    n_rows = int(torch.unique(rows).numel())
    nbytes = (K * N * C * 4 + 2 * K * N * 4 + K * s_idx.element_size()
              + n_rows * C * maps.element_size())
    flops = 13 * K * N * C
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_main_path(ps, card: str):
    """Two frames + matching through the entry points; returns the
    frame-A inputs of each kernel launch and the launch count."""
    from sara_tpu_torch.features.api import SIFTParams, compute_sift_keypoints
    from sara_tpu_torch.matching.brute_force import (MatchParams,
                                                     match_descriptors)

    h, w = FRAME_HW
    tex = texture(1, h, w + SHIFT_PX)
    frame_a = tex[:, SHIFT_PX:]          # A(x) = tex(x + 16) = B(x + 16)
    frame_b = tex[:, :w]
    params = SIFTParams(desc_sampler="kernel", desc_sample_nearest=False)

    # Record the inputs of each launch (forwarded unchanged to the wrapper).
    wrapper = ps.sample_field_patches
    recorded = []

    def recording(*args, **kwargs):
        recorded.append(args[:4])
        return wrapper(*args, **kwargs)

    compute_sift_keypoints(frame_a, params)         # warm-up
    torch.cuda.synchronize()

    ps.sample_field_patches = recording
    try:
        ps.reset_counts()
        t0 = time.perf_counter()
        ka = compute_sift_keypoints(frame_a, params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kb = compute_sift_keypoints(frame_b, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m = match_descriptors(ka, kb, MatchParams(ratio=0.8))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = ps.counts()
    finally:
        ps.sample_field_patches = wrapper
    times = [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]
    log(f"main path: frame A {times[0]:.2f} ms, frame B {times[1]:.2f} ms, "
        f"match {times[2]:.2f} ms ({card})")
    log(f"patch_sampler launches on the main path: {json.dumps(counts)}")
    launches = counts["K1"]
    check(counts == {"K1": 12, "K1 general": 0, "K2": 0, "K2 general": 0,
                     "index copies": 0},
          "expected 12 launches of K1's vector variant (6 octaves x 2 "
          "frames), no other kernel and no index copy")

    for name, k in (("A", ka), ("B", kb)):
        check(k.descriptors.shape == (params.total_capacity, 128),
              f"frame {name}: descriptor shape {tuple(k.descriptors.shape)}")
        check(bool(torch.isfinite(k.descriptors).all()
                   and torch.isfinite(k.xy).all()),
              f"frame {name}: non-finite output")
        check(int(k.count()) > 0, f"frame {name}: no keypoints")
    n_match = int(m.count())
    i, j = m.i[m.mask].long(), m.j[m.mask].long()
    d = kb.xy[j] - ka.xy[i]
    on_shift = ((d[:, 0] - SHIFT_PX).abs() <= 1) & (d[:, 1].abs() <= 1)
    frac = float(on_shift.float().mean()) if n_match else 0.0
    log(f"keypoints A={int(ka.count())} B={int(kb.count())}, "
        f"matches={n_match}, on the {SHIFT_PX}-px shift: {frac:.4f}")
    check(n_match >= 100 and frac >= 0.9,
          f"matches {n_match}, on-shift fraction {frac}")

    # The gather sampler computes the same function: same keypoints,
    # descriptors within the tolerance.
    kg = compute_sift_keypoints(
        frame_a, dataclasses.replace(params, desc_sampler="gather"))
    for f in ("xy", "scale", "orientation", "response", "mask"):
        check(torch.equal(getattr(ka, f), getattr(kg, f)),
              f"kernel vs gather: {f} differ")
    derr = (ka.descriptors[ka.mask] - kg.descriptors[kg.mask]).abs().max()
    log(f"kernel vs gather descriptors (frame A): max_abs_err={derr:.3e}")
    check(float(derr) <= TOLERANCE, f"kernel vs gather descriptors {derr}")

    # Steady state: frames/s over 5 more frames of A.
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        compute_sift_keypoints(frame_a, params)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(steady))
    log(f"frontend steady state: {med:.2f} ms/frame median of 5, "
        f"{1e3 / med:.2f} frames/s ({card})")
    profile_frame(lambda: compute_sift_keypoints(frame_a, params), med)
    return recorded[:6], launches, (ka, kb, m)


def phase_packed_path(ps, recorded):
    """K2's path: frame A's six sampler launches through
    ``sample_field_patches(..., pack_x=True)``. Octaves 0-4 (W = 1280 .. 80,
    multiples of 16) take K2, octave 5 (W = 40) takes K1, as the
    reference's dispatcher rule says, both in the vector variant. Returns
    (K2 launches, K1 launches, worst error against K2's plain version and
    against K1)."""
    ps.reset_counts()
    outs = [ps.sample_field_patches(*args, max_sample_radius=0, pack_x=True)
            for args in recorded]
    torch.cuda.synchronize()
    counts = ps.counts()
    k2, k1 = counts["K2"], counts["K1"]
    log(f"pack_x path: launches {json.dumps(counts)}")
    check(counts == {"K1": 1, "K1 general": 0, "K2": 5, "K2 general": 0,
                     "index copies": 0},
          "pack_x path: expected 5 launches of K2's vector variant and 1 "
          "of K1's, and nothing else")
    worst = 0.0
    for octave, ((maps, s_idx, ys, xs), out) in enumerate(zip(recorded,
                                                              outs)):
        plain = (ps._sample_patches_packed_reference
                 if ps.packed_layout_ok(maps.shape)
                 else ps._sample_patches_reference)
        ref = plain(maps, s_idx, ys, xs)
        via_k1 = ps.sample_field_patches(maps, s_idx, ys, xs,
                                         max_sample_radius=0)
        torch.cuda.synchronize()
        err = max((out - ref).abs().max().item(),
                  (out - via_k1).abs().max().item())
        log(f"pack_x octave {octave} {tuple(maps.shape)}: max_abs_err vs "
            f"plain and K1 {err:.3e}")
        check(err <= TOLERANCE, f"pack_x octave {octave}: error {err}")
        worst = max(worst, err)
    return k2, k1, worst


def profile_frame(fn, wall_ms: float, top: int = 12,
                  what: str = "frame") -> None:
    """Where one call's device time goes (torch.profiler): the device's
    busy time beside the unprofiled wall time, the count of device
    operations (kernel launches, copies and memsets) and the kernels that
    take the most of it. Returns that summary; prints "not measured" and
    returns None if the profiler sees no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # Device activity only: the host operators' events are not read, and
    # collecting them slows a call of many launches and its summary.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events only: a CPU operator also reports the device time
    # of the kernels it launched, which would count them twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms == 0:
        log(f"{what} profile: device time not measured (no device events)")
        return None
    events.sort(key=dev_us, reverse=True)
    summary = {
        "profiling_s": time.perf_counter() - t0,
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ops": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "calls": e.count,
                 "device_ms": dev_us(e) / 1e3} for e in events[:top]]}
    log(f"{what} profile", json.dumps(summary))
    return summary


def sampler_requested_bytes(maps, s_idx, ys) -> int:
    """Bytes the kernels request: outputs, coordinates and indices once,
    and four tap rows per sample (shared rows counted each time)."""
    K, N = ys.shape
    C = maps.shape[3]
    return (K * N * C * 4 + 2 * K * N * 4 + K * s_idx.element_size()
            + 4 * K * N * C * maps.element_size())


def phase_timing(ps, recorded, packed: bool = False):
    """On each frame-A launch's own inputs: the kernel's vector variant and
    its general variant (the first Hopper kernel) timed in turns (general,
    vector, vector, general), its plain version, a library call, the
    launch floor and a contiguous copy (``Tensor.copy_``) that moves as many
    bytes as the kernel requests, beside the bound; returns per-launch
    rows. ``packed``: K2 and its plain version, on the launches K2 takes
    (octaves 0-4)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    plain = (ps._sample_patches_packed_reference if packed
             else ps._sample_patches_reference)
    name = "K2" if packed else "K1"
    rows = []
    for octave, (maps, s_idx, ys, xs) in enumerate(recorded):
        if packed and not ps.packed_layout_ok(maps.shape):
            continue
        run = {vector: (lambda v=vector: ps._launch(
            maps, s_idx, ys, xs, packed=packed, vector=v))
            for vector in (False, True)}
        out = ps.sample_field_patches(maps, s_idx, ys, xs,
                                      max_sample_radius=0, pack_x=packed)
        ref = plain(maps, s_idx, ys, xs)
        old = run[False]()
        lib_call, lib_view = sampler_library_call(maps, s_idx, ys, xs)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        old_err = (old - ref).abs().max().item()
        lib_err = (lib_view(lib_call()) - out).abs().max().item()
        check(err <= TOLERANCE and old_err <= TOLERANCE,
              f"{name} octave {octave}: vector / general vs plain "
              f"{err} / {old_err}")
        bound, bound_by = sampler_bound_ms(maps, s_idx, ys, xs)
        turns = [timed_ms(run[v], flush=flush)
                 for v in (False, True, True, False)]
        requested = sampler_requested_bytes(maps, s_idx, ys)
        src = torch.empty(requested // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)       # reads and writes requested / 2
        row = {
            "octave": octave, "maps": list(maps.shape), "K": ys.shape[0],
            "N": ys.shape[1], "max_abs_err": err, "old_max_abs_err": old_err,
            "ms": (turns[1] + turns[2]) / 2, "old_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": turns,
            "plain_ms": timed_ms(lambda: plain(maps, s_idx, ys, xs),
                                 flush=flush),
            "library_ms": timed_ms(lib_call, flush=flush),
            "library_max_abs_err": lib_err,
            "floor_ms": timed_ms(ps.launch_floor, flush=flush),
            "requested_bytes": requested,
            "copy_ms": timed_ms(lambda: dst.copy_(src), flush=flush),
            "bound_ms": bound, "bound_by": bound_by,
        }
        log(f"{name} at main-path shape", json.dumps(row))
        rows.append(row)
    return rows


def compare_k1_k2(ps, recorded) -> None:
    """K1 and K2 on the same pack_x launches, timed in turns (K1, K2, K2,
    K1) so that clocks and neighbours weigh on both alike."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for octave, (maps, s_idx, ys, xs) in enumerate(recorded):
        if not ps.packed_layout_ok(maps.shape):
            continue
        run = {packed: (lambda p=packed: ps.sample_field_patches(
            maps, s_idx, ys, xs, max_sample_radius=0, pack_x=p))
            for packed in (False, True)}
        t = [timed_ms(run[p], flush=flush) for p in (False, True, True,
                                                      False)]
        rows.append({"octave": octave, "k1_ms": (t[0] + t[3]) / 2,
                     "k2_ms": (t[1] + t[2]) / 2})
    log("K1 vs K2 in turns", json.dumps(rows))


def count_syncs(fn) -> dict:
    """The host syncs PyTorch reports in one call of ``fn``: their count and
    the source lines that made them (``utils/timing.py::count_syncs``)."""
    from sara_tpu_torch.utils.timing import count_syncs as port_count_syncs

    return port_count_syncs(fn)


def make_two_view_scene(seed: int = 0, slots: int = 8192, n_valid: int = 4096,
                        outlier_frac: float = 0.3, noise_px: float = 0.5):
    """A synthetic two-view scene in numpy (the geometry of
    tests/geometry_fixtures.py at the size of a real frame pair): K with
    f = 800 at 640x480, camera 2 at x2 = R x1 + t. ``n_valid`` of ``slots``
    rows are correspondences, scattered among invalid rows of noise; a
    fraction ``outlier_frac`` of them get a random pixel in view 2. Pixels
    carry Gaussian noise of ``noise_px``."""
    rs = np.random.RandomState(seed)
    K = np.array([[800.0, 0.0, 320.0], [0.0, 800.0, 240.0], [0.0, 0.0, 1.0]])
    yaw, pitch, roll = 0.1, -0.05, 0.03
    cz, sz, cy, sy, cx, sx = (np.cos(yaw), np.sin(yaw), np.cos(pitch),
                              np.sin(pitch), np.cos(roll), np.sin(roll))
    R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    t = np.array([1.0, 0.1, 0.05])
    pix = rs.uniform([0, 0], [640, 480], (slots, 2))
    depth = rs.uniform(4.0, 12.0, slots)
    X = depth[:, None] * (np.c_[pix, np.ones(slots)] @ np.linalg.inv(K).T)
    Xc2 = X @ R.T + t
    p2 = Xc2 @ K.T
    u = pix + rs.normal(scale=noise_px, size=(slots, 2))
    v = p2[:, :2] / p2[:, 2:] + rs.normal(scale=noise_px, size=(slots, 2))
    mask = np.zeros(slots, bool)
    mask[rs.choice(slots, n_valid, replace=False)] = True
    valid = np.flatnonzero(mask)
    out = rs.choice(valid, int(round(outlier_frac * n_valid)), replace=False)
    v[out] = rs.uniform([0, 0], [640, 480], (len(out), 2))
    inlier = mask.copy()
    inlier[out] = False
    invalid = ~mask
    u[invalid] = rs.uniform(-1e3, 1e3, (invalid.sum(), 2))   # garbage rows
    v[invalid] = rs.uniform(-1e3, 1e3, (invalid.sum(), 2))
    ray2 = np.c_[v, np.ones(slots)] @ np.linalg.inv(K).T
    ray2 /= np.linalg.norm(ray2, axis=1, keepdims=True)
    return dict(K=K, R=R, t=t, u=u, v=v, X=X, rays=ray2, mask=mask,
                inlier=inlier)


def rotation_deg(A, B) -> float:
    c = (np.trace(A.T @ B) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def direction_deg(a, b) -> float:
    c = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def timed_call_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median wall time of ``fn`` over ``reps`` calls after one warm-up,
    each ending in a device synchronize."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_two_view(frames, card: str, device="cuda", num_samples: int = 1000,
                   scene_kw=None) -> dict:
    """Slice B through its entry points: the homography of the frame pair's
    matches, then the relative pose, fundamental matrix and absolute pose
    of the synthetic scene. Checks the geometry, times each estimator
    (median of 5 after a warm-up) and, on the card, profiles one relative
    pose. ``frames`` = (ka, kb, m) of the frame path, or None to skip the
    homography. Returns the measurements."""
    from sara_tpu_torch.mvg.two_view import (sampson_epipolar_distance,
                                             two_view_geometry)
    from sara_tpu_torch.ransac import (estimate_absolute_pose,
                                       estimate_fundamental,
                                       estimate_homography,
                                       estimate_relative_pose)

    dev = torch.device(device)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)   # noqa: E731
    out = {}
    if frames is not None:
        ka, kb, m = frames
        u, v = ka.xy, kb.xy[m.j.long()]
        run = lambda: estimate_homography(gen(), u, v, m.mask,   # noqa: E731
                                          threshold=4.0,
                                          num_samples=num_samples)
        res = run()
        H = res.model.double().cpu().numpy()
        h, w = FRAME_HW
        c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], float)
        moved = c @ H.T
        err = np.abs(moved[:, :2] / moved[:, 2:] - c[:, :2]
                     - [SHIFT_PX, 0]).max()
        n_match, n_inl = int(m.count()), int(res.num_inliers)
        out["homography"] = {"matches": n_match, "inliers": n_inl,
                             "corner_err_px": float(err),
                             "ms": timed_call_ms(run, dev)}
        log("estimate_homography", json.dumps(out["homography"]), f"({card})")
        check(bool(res.success) and err <= 0.5 and n_inl >= 0.9 * n_match,
              f"homography: corner error {err} px, {n_inl}/{n_match} inliers")

    sc = make_two_view_scene(**(scene_kw or {}))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    u, v, K, X, rays = (f(sc[k]) for k in ("u", "v", "K", "X", "rays"))
    mask = torch.as_tensor(sc["mask"], device=dev)
    truth = sc["inlier"]

    def report(name, res, R, t, run, dir_gate=True, **extra):
        """Log and check one estimator: success, recall >= 90% of the true
        inliers, rotation error <= 0.5 deg and (``dir_gate``) translation
        direction <= 2 deg."""
        R = R.double().cpu().numpy()
        t = t.double().cpu().numpy()
        inl = res.inliers.cpu().numpy()
        row = {"rot_err_deg": rotation_deg(R, sc["R"]),
               "dir_err_deg": direction_deg(t, sc["t"]),
               "recall": float((inl & truth).sum() / truth.sum()),
               "false_inliers": int((inl & ~truth).sum()),
               "inliers": int(res.num_inliers), **extra,
               "ms": timed_call_ms(run, dev)}
        out[name] = row
        log(name, json.dumps(row), f"({card})")
        ok = (bool(res.success) and row["recall"] >= 0.9
              and row["rot_err_deg"] <= 0.5)
        if dir_gate:
            ok = ok and row["dir_err_deg"] <= 2.0
        check(ok, f"{name}: {row}")

    run = lambda: estimate_relative_pose(gen(), u, v, mask, K, K,  # noqa: E731
                                         num_samples=num_samples,
                                         min_inliers=100)
    res, R, t = run()
    report("estimate_relative_pose", res, R, t, run)
    if dev.type == "cuda":
        profile_frame(run, out["estimate_relative_pose"]["ms"],
                      what="relative pose")
        log("relative pose: host syncs", json.dumps(count_syncs(run)))

    run = lambda: estimate_fundamental(gen(), u, v, mask,  # noqa: E731
                                       num_samples=num_samples)
    res = run()
    # F is the best minimal 7-point model (the estimator refits nothing), so
    # besides its inliers it is held to its epipolar error on the true
    # inliers (median Sampson distance <= 1 px at 0.5 px noise) and to the
    # rotation in it (E = K^T F K, resolved by cheirality); the translation
    # direction of an unrefined 7-point F is logged, not gated.
    Kinv = torch.linalg.inv(K)
    ray = lambda p: torch.cat([p, torch.ones_like(p[:, :1])], 1) @ Kinv.T  # noqa: E731
    R, t, _, _, _ = two_view_geometry(K.T @ res.model @ K, ray(u), ray(v),
                                      res.inliers)
    sampson = sampson_epipolar_distance(res.model, u, v).cpu().numpy()
    med = float(np.median(sampson[truth]))
    report("estimate_fundamental", res, R, t, run, dir_gate=False,
           sampson_median_px=med)
    check(med <= 1.0, f"estimate_fundamental: median Sampson {med} px")

    run = lambda: estimate_absolute_pose(gen(), X, rays, v, K,  # noqa: E731
                                         mask, num_samples=num_samples)
    res, R, t = run()
    report("estimate_absolute_pose", res, R, t, run)
    return out


VO_HW = (480, 640)
VO_FRAMES = 30          # 12 through process_frame, 18 through process_frames
VO_WARM = 12
VO_LOOP = 100           # the circular loop's length (scripts/eval_vo.py)
# Pipeline stages timed one by one on the VO path (the rest of a frame is
# matching, tracks, triangulation and host bookkeeping).
VO_STAGES = ("_detect", "_relative_pose", "_pnp", "_bundle_adjust")


def load_helper(name: str):
    """A helper module of ``tests/`` (numpy + scipy) from the checkout, by
    path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vo_frames(n: int, hw=VO_HW, first: int = 0, loop: int = VO_LOOP):
    """Frames ``first`` .. ``first + n - 1`` of the circular loop of
    scripts/eval_vo.py (``loop`` poses, a = 2 pi i / loop, gentle yaw)
    through ``make_room(seed=1)``: (K, images, camera centres)."""
    r3 = load_helper("render3d")
    h, w = hw
    K = np.array([[0.94 * w, 0, w / 2], [0, 0.94 * w, h / 2], [0, 0, 1.0]])
    planes = r3.make_room(seed=1)
    imgs, centers = [], []
    for i in range(first, first + n):
        a = 2 * np.pi * i / loop
        c = np.array([0.5 + 1.6 * np.sin(a), 0.0, 4.0 + 1.6 * (1 - np.cos(a))])
        yaw = 0.25 * np.sin(a)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        with np.errstate(invalid="ignore", divide="ignore"):
            imgs.append(np.asarray(r3.render(planes, K, R, -R @ c, hw=hw),
                                   np.float32))
        centers.append(c)
    return K, imgs, np.asarray(centers)


def vo_config():
    """scripts/eval_vo.py's configuration with the kernel sampler."""
    from sara_tpu_torch.sfm import OdometryConfig

    return OdometryConfig(
        rel_pose_samples=300, pnp_samples=300, rel_pose_min_inliers=40,
        pnp_min_inliers=15, ba_window=8, full_ba_every=8, frontend_batch=4,
        sift=dataclasses.replace(OdometryConfig().sift,
                                 desc_sampler="kernel"))


def phase_vo(ps, card: str, device="cuda", n_frames: int = VO_FRAMES,
             warm: int = VO_WARM, hw=VO_HW) -> dict:
    """The VO path at full width: ``n_frames`` renders of the room through
    ``OdometryPipeline``, frames 0 .. warm - 1 by ``process_frame`` and the
    rest by ``process_frames`` (windows of 4 through the batched frontend,
    ``sfm/odometry.py::_fused_frontend_batch``). The sampler counts are
    set to 0 just before and read just after. Gates: all frames but one
    accepted, ATE <= 0.10 after similarity alignment, > 500 map points, the
    native union-find, and on the card K1's vector variant, one launch per
    octave for each frame of ``process_frame`` and for each window (not
    each frame) of ``process_frames``, with no index copy. Records steady
    ms per frame, the steady frames' time per stage (the fused window,
    detection, relative pose, PnP, BA, the rest) and BA ms per call.
    Then two more frames of the loop, with the stage timers removed: one
    for the host syncs, one profiled. Returns the measurements."""
    from sara_tpu_torch.features.api import compute_sift_keypoints
    from sara_tpu_torch.sfm import OdometryPipeline
    from sara_tpu_torch.sfm import disjoint_sets, odometry
    from sara_tpu_torch.utils import ate_rmse

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    K, imgs, centers = vo_frames(n_frames + 2, hw)
    log(f"vo: rendered {len(imgs)} frames {hw} in "
        f"{time.perf_counter() - t0:.2f} s")
    backend = disjoint_sets.backend()
    check(backend == "native", f"vo: union-find backend {backend}")
    cfg = vo_config()

    # K1 launches of one frame's detection (one per octave).
    ps.reset_counts()
    compute_sift_keypoints(imgs[0], cfg.sift, device=dev)
    sync()
    per_frame = ps.counts()["K1"]

    pipe = OdometryPipeline(K, cfg, device=dev)
    # Host clock around each stage, ending in a synchronize (the stages'
    # own syncs aside, the pipeline does not overlap them).
    stage_ms = {name: [] for name in VO_STAGES + ("_fused_window",)}
    B = cfg.frontend_batch

    def timed(name, fn):
        def run(*a, **kw):
            sync()
            t = time.perf_counter()
            result = fn(*a, **kw)
            sync()
            stage_ms[name].append((time.perf_counter() - t) * 1e3)
            return result
        return run

    for name in VO_STAGES:
        setattr(pipe, name, timed(name, getattr(pipe, name)))
    fused = odometry._fused_frontend_batch
    odometry._fused_frontend_batch = timed("_fused_window", fused)
    ps.reset_counts()
    t_start = time.perf_counter()
    ok = [bool(pipe.process_frame(imgs[f], f)) for f in range(warm)]
    sync()
    t_warm = time.perf_counter()
    n_warm = {name: len(v) for name, v in stage_ms.items()}
    ok += [bool(o) for o in pipe.process_frames(
        imgs[warm:n_frames], list(range(warm, n_frames)))]
    sync()
    t_end = time.perf_counter()
    counts = ps.counts()
    for name in VO_STAGES:
        delattr(pipe, name)
    odometry._fused_frontend_batch = fused
    windows = len(stage_ms["_fused_window"])

    accepted = int(sum(ok))
    ate = ate_rmse(pipe.trajectory(), centers[:n_frames][np.flatnonzero(ok)])
    n_steady = max(n_frames - warm, 1)
    steady = (t_end - t_warm) * 1e3 / n_steady
    stages = {name.strip("_"): sum(v[n_warm[name]:]) / n_steady
              for name, v in stage_ms.items()}
    stages["rest"] = steady - sum(stages.values())
    ba_ms = stage_ms["_bundle_adjust"]
    out = {"frames": n_frames, "accepted": accepted, "ate": ate,
           "path_length": float(np.linalg.norm(
               np.diff(centers[:n_frames], axis=0), axis=1).sum()),
           "map_points": pipe.point_cloud.num_points,
           "warm_ms_per_frame": (t_warm - t_start) * 1e3 / warm,
           "steady_ms_per_frame": steady,
           "steady_stage_ms_per_frame": stages,
           "ba_calls": len(ba_ms),
           "ba_ms_median": float(np.median(ba_ms)) if ba_ms else None,
           "k1_per_frame": per_frame, "windows": windows,
           "sampler_counts": counts, "union_find": backend}
    log("vo", json.dumps(out), f"({card})")
    check(accepted >= n_frames - 1, f"vo: {accepted}/{n_frames} accepted")
    check(ate <= 0.10, f"vo: ATE {ate}")
    check(out["map_points"] > 500, f"vo: {out['map_points']} map points")
    if dev.type == "cuda":
        check(per_frame >= 1 and windows == -(-(n_frames - warm) // B)
              and counts == {
                  "K1": (warm + windows) * per_frame, "K1 general": 0,
                  "K2": 0, "K2 general": 0, "index copies": 0},
              f"vo: expected ({warm} frames + {windows} windows) x "
              f"{per_frame} launches of K1's vector variant and nothing "
              f"else, got {counts}")
        out["syncs"] = count_syncs(
            lambda: pipe.process_frame(imgs[n_frames], n_frames))
        log("vo: host syncs in one steady frame", json.dumps(out["syncs"]))
        profile_frame(lambda: pipe.process_frame(imgs[n_frames + 1],
                                                 n_frames + 1),
                      steady, top=15, what="vo frame")
    return out


BA_SIZE = dict(C=256, P=100_000, O=800_000)     # scripts/bench_ba.py "large"


def make_ba_problem(C, P, O, seed=0, device="cuda", dtype=torch.float32):
    """scripts/bench_ba.py::make_problem in numpy: P points in front of C
    cameras along the x axis, O random observations with 0.5 px noise,
    poses and points perturbed; camera 0 fixed. A port BAProblem on
    ``device``."""
    from sara_tpu_torch.ba import BAProblem
    from sara_tpu_torch.core import lie

    rs = np.random.RandomState(seed)
    X = rs.uniform(-10, 10, (P, 3)) + np.array([0, 0, 30.0])
    intr = np.array([800.0, 800.0, 512.0, 384.0])
    poses = np.zeros((C, 6))
    poses[:, 3] = np.linspace(0, 10.0, C)
    poses[:, :3] = rs.normal(scale=0.01, size=(C, 3))
    cam_idx = rs.randint(0, C, O).astype(np.int32)
    pt_idx = rs.randint(0, P, O).astype(np.int32)
    Rm = lie.so3_exp(torch.from_numpy(poses[:, :3])).numpy()
    Xc = np.einsum("oij,oj->oi", Rm[cam_idx], X[pt_idx]) + poses[cam_idx, 3:]
    z = np.clip(Xc[:, 2], 1.0, None)
    uv = np.stack([intr[0] * Xc[:, 0] / z + intr[2],
                   intr[1] * Xc[:, 1] / z + intr[3]], axis=1)
    uv += rs.normal(scale=0.5, size=uv.shape)
    pose_fixed = np.zeros(C, bool)
    pose_fixed[0] = True
    f = lambda a: torch.as_tensor(a, dtype=dtype).to(device)  # noqa: E731
    t = lambda a: torch.as_tensor(a).to(device)               # noqa: E731
    return BAProblem(
        poses=f(poses + np.concatenate(
            [np.zeros((1, 6)), rs.normal(scale=2e-3, size=(C - 1, 6))])),
        points=f(X + rs.normal(scale=5e-2, size=X.shape)),
        intrinsics=f(intr), cam_idx=t(cam_idx), pt_idx=t(pt_idx), uv=f(uv),
        obs_mask=t(np.ones(O, bool)), pose_fixed=t(pose_fixed),
        point_fixed=t(np.zeros(P, bool)))


def events_ms(fn, device) -> tuple:
    """(result, ms) of one call of ``fn``, by CUDA events after a
    synchronize (host clock on the CPU)."""
    if device.type != "cuda":
        t = time.perf_counter()
        return fn(), (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_ba(card: str, device="cuda", size=None, iters: int = 10) -> dict:
    """Bundle adjustment at realistic size (bench_ba.py's "large" problem,
    float32): ``iters`` LM iterations each through ``bundle_adjust`` (the
    dense-Schur strata path), ``DenseSchurSession.solve`` (packed once,
    solved twice) and ``bundle_adjust_cg`` (15 CG iterations). Gates: every
    final cost below its initial cost, dense and CG within 1%, the
    session's second solve continuing from the first. Records ms per LM
    iteration (CUDA events), host syncs per ``bundle_adjust`` call, peak
    device memory, and a profile of one dense call."""
    from sara_tpu_torch.ba import (BAOptions, DenseSchurSession,
                                   bundle_adjust, bundle_adjust_cg)
    from sara_tpu_torch.ba import dense_schur

    dev = torch.device(device)
    size = size or BA_SIZE
    t0 = time.perf_counter()
    prob = make_ba_problem(**size, device=dev)
    log(f"ba: problem {json.dumps(size)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    opts = BAOptions(max_iters=iters)
    cg_opts = BAOptions(max_iters=iters, cg_iters=15, solver="cg")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"size": size, "iters": iters}

    strata, ids, stats = dense_schur.pack_pt_major_strata(
        prob, chunk=opts.dense_chunk)
    check(dense_schur.dense_eligible(stats, opts),
          f"ba: the dense path declines this problem ({stats})")
    # Operations of the S contraction in one LM iteration: per chunk of Q
    # points, the (6C x 3Q) @ (3Q x 6C) product of H and D.
    n_chunks = [ptm.cam_idx.shape[0] // q
                for ptm, q in zip(strata, stats["chunks"])]
    out["strata"] = {"sps": stats["sps"], "chunks": stats["chunks"],
                     "n_chunks": n_chunks,
                     "inflation": stats["inflation"],
                     "s_contraction_flop_per_iter": sum(
                         2 * (6 * size["C"]) ** 2 * 3 * q * n
                         for q, n in zip(stats["chunks"], n_chunks))}
    # Warm-up calls (allocator, cuBLAS / cuSOLVER handles), not timed.
    bundle_adjust(prob, BAOptions(max_iters=1))
    bundle_adjust_cg(prob, BAOptions(max_iters=1, cg_iters=15, solver="cg"))

    (res, info), ms = events_ms(lambda: bundle_adjust(prob, opts), dev)
    (_, _, info_lm), lm_ms = events_ms(
        lambda: dense_schur.dense_schur_bundle_adjust_strata(
            tuple(strata), opts, tuple(stats["chunks"])), dev)
    out["dense"] = {"initial_cost": float(info["initial_cost"]),
                    "final_cost": float(info["final_cost"]),
                    "call_ms": ms, "lm_loop_ms": lm_ms,
                    "ms_per_lm_iter": lm_ms / iters}
    sess = DenseSchurSession(prob, opts)
    (_, _, s1), ms1 = events_ms(sess.solve, dev)
    (_, _, s2), ms2 = events_ms(sess.solve, dev)
    out["session"] = {"first": [float(s1["initial_cost"]),
                                float(s1["final_cost"])],
                      "second": [float(s2["initial_cost"]),
                                 float(s2["final_cost"])],
                      "ms_per_lm_iter": [ms1 / iters, ms2 / iters]}
    (cg_res, cg_info), cg_ms = events_ms(
        lambda: bundle_adjust_cg(prob, cg_opts), dev)
    out["cg"] = {"initial_cost": float(cg_info["initial_cost"]),
                 "final_cost": float(cg_info["final_cost"]),
                 "call_ms": cg_ms, "ms_per_lm_iter": cg_ms / iters}
    if dev.type == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["syncs_bundle_adjust"] = count_syncs(
            lambda: bundle_adjust(prob, opts))
        out["syncs_cg"] = count_syncs(lambda: bundle_adjust_cg(prob,
                                                                cg_opts))
    log("ba", json.dumps(out), f"({card})")
    for name in ("dense", "cg"):
        check(out[name]["final_cost"] < out[name]["initial_cost"],
              f"ba: {name} did not lower the cost: {out[name]}")
    check(s1["final_cost"] < s1["initial_cost"]
          and s2["final_cost"] <= s1["final_cost"],
          f"ba: session costs {out['session']}")
    check(abs(float(s2["initial_cost"]) - float(s1["final_cost"]))
          <= 1e-6 * float(s1["final_cost"]),
          "ba: the session's second solve did not start where the first "
          "ended")
    gap = (abs(out["dense"]["final_cost"] - out["cg"]["final_cost"])
           / out["cg"]["final_cost"])
    out["dense_vs_cg"] = gap
    check(gap <= 0.01, f"ba: dense and CG final costs differ by {gap:.4f}")
    for name, p in (("dense", res), ("cg", cg_res)):
        check(bool(torch.isfinite(p.poses).all()
                   and torch.isfinite(p.points).all()),
              f"ba: non-finite {name} result")
    if dev.type == "cuda":
        profile_frame(lambda: bundle_adjust(prob, opts), ms, top=15,
                      what="bundle_adjust (dense)")
    return out

LOOP_HW = (240, 320)        # scripts/eval_vo.py --room's default size
LOOP_FRAMES = 100           # BASELINE config 3: the whole 100-frame loop
# Phase "loop"'s ATE gate after closure, held to the reference package on
# the same frames. tests/loop_witness.py ran the reference's own loop VO
# (jax.jit of its float32 BA, eval_vo's configuration) on these 100 frames
# with BAOptions.lambda_init x (1 + k 1e-6), k = -4..4, on an 8-core AMD
# EPYC CPU (JAX 0.9.0), reference package as of commit 2ba37d0: ATE after
# closure below (k = -4..4; before closure 0.2749-0.9977), every run with
# 100 frames accepted and 3 metric loop edges. Its float32 BA drifts where
# summation order says, so none of its nine runs meets the earlier gate of
# 0.15; the gate is 1.25 x its largest (a tenth draw beats the largest of
# nine one time in ten).
LOOP_REFERENCE_ATE_AFTER = (0.5399, 0.3619, 0.3894, 0.5046, 0.3910, 0.3454,
                            0.2531, 0.4707, 0.1798)
LOOP_ATE_GATE = 1.25 * max(LOOP_REFERENCE_ATE_AFTER)


def replay_closer(closer, gen_state):
    """A LoopCloser holding ``closer``'s frames and codebook, its generator
    at ``gen_state`` and no loop edges: it repeats a ``close`` call."""
    from sara_tpu_torch.sfm.loop_closure import LoopCloser

    c = LoopCloser(closer.K, closer.cfg, device=closer.device)
    c.signatures = list(closer.signatures)
    c.keypoint_sets = list(closer.keypoint_sets)
    c._codebook, c._codebook_dev = closer._codebook, closer._codebook_dev
    c._gen.set_state(gen_state)
    return c


def phase_loop(ps, card: str, device="cuda", n_frames: int = LOOP_FRAMES,
               hw=LOOP_HW, warm: int = VO_WARM) -> dict:
    """BASELINE config 3 as ``scripts/eval_vo.py --room --frames 100
    --loop`` runs it: ``n_frames`` renders of the room on the circular loop
    (which returns to its start) through ``OdometryPipeline.process_frame``
    with ``vo_config()``, a ``LoopCloser`` (min_gap = max(n / 4, 15), 40
    inliers, 300 hypotheses) fed by the ``on_accept`` hook, then
    ``closer.close(pipe, accepted - 1)``. The sampler counts are set to 0
    just before the first frame and read just after ``close``. Gates: all
    frames but one accepted, a loop closed with at least one verified
    metric edge, ATE after <= 1.05 x ATE before + 1e-6 and <=
    ``LOOP_ATE_GATE`` (the reference's own loop on these frames), a finite
    pose graph and map, the native union-find, and on the card K1's vector
    variant on every frame and nothing else. Then the state goes through
    ``save_sfm_state`` / ``load_sfm_state`` into a fresh pipeline, which
    must hold the same trajectory, map and generator state. Records ms per
    frame (warm: frames 0 .. warm - 1; steady: the rest), ATE before and
    after, the loop edges, the Sim(3) scale drift, ``close``'s ms and, on
    a replay of the same ``close``, its host syncs and a profile."""
    import tempfile
    from pathlib import Path

    from sara_tpu_torch.features.api import compute_sift_keypoints
    from sara_tpu_torch.io import load_sfm_state, save_sfm_state
    from sara_tpu_torch.sfm import OdometryPipeline, disjoint_sets
    from sara_tpu_torch.sfm import loop_closure as lc
    from sara_tpu_torch.utils import ate_rmse
    from sara_tpu_torch.utils.host import fetch

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    K, imgs, centers = vo_frames(n_frames, hw, loop=n_frames)
    log(f"loop: rendered {len(imgs)} frames {hw} in "
        f"{time.perf_counter() - t0:.2f} s")
    backend = disjoint_sets.backend()
    check(backend == "native", f"loop: union-find backend {backend}")
    cfg = vo_config()
    ps.reset_counts()
    compute_sift_keypoints(imgs[0], cfg.sift, device=dev)
    sync()
    per_frame = ps.counts()["K1"]

    pipe = OdometryPipeline(K, cfg, device=dev)
    closer = lc.LoopCloser(K, lc.LoopClosureConfig(
        min_gap=max(n_frames // 4, 15), min_inliers=40,
        rel_pose_samples=300), device=dev)
    pipe.on_accept = lambda kp, vid: closer.add_frame(kp)
    # Forwarded unchanged; keeps the pose-graph problem and its result.
    optimize = lc.optimize_pose_graph
    seen = {}

    def recording(prob, **kwargs):
        result = optimize(prob, **kwargs)
        seen.update(prob=prob, kwargs=kwargs, result=result)
        return result

    ps.reset_counts()
    t_frames = time.perf_counter()
    frame_ms, ok = [], []
    for f in range(n_frames):
        t = time.perf_counter()
        ok.append(bool(pipe.process_frame(imgs[f], f)))
        sync()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    t_frames = time.perf_counter() - t_frames
    accepted = int(sum(ok))
    gt = centers[np.flatnonzero(ok)]
    ate_before = ate_rmse(pipe.trajectory(), gt)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    t_save = time.perf_counter()
    save_sfm_state(str(tmp / "before_close.npz"), pipe)
    t_save = time.perf_counter() - t_save
    gen_state = closer._gen.get_state()
    lc.optimize_pose_graph = recording
    try:
        sync()
        t = time.perf_counter()
        closed = closer.close(pipe, accepted - 1)
        sync()
        close_ms = (time.perf_counter() - t) * 1e3
    finally:
        lc.optimize_pose_graph = optimize
    counts = ps.counts()
    traj = pipe.trajectory()
    ate_after = ate_rmse(traj, gt)
    points = pipe.point_cloud.points
    out = {"frames": n_frames, "hw": list(hw), "accepted": accepted,
           "warm_ms_per_frame": float(np.mean(frame_ms[:warm])),
           "steady_ms_per_frame": float(np.mean(frame_ms[warm:])),
           "steady_ms_per_frame_median": float(np.median(frame_ms[warm:])),
           "ate_before": ate_before, "ate_after": ate_after,
           "path_length": float(np.linalg.norm(
               np.diff(centers, axis=0), axis=1).sum()),
           "map_points": pipe.point_cloud.num_points, "closed": bool(closed),
           "loop_edges": [{"a": int(a), "b": int(b), "inliers": int(n),
                           "kind": "metric" if metric else "E-only",
                           "rel_scale": d_rel}
                          for (a, b, _R, _t, n, metric, d_rel)
                          in closer.loop_edges],
           "frames_s": t_frames, "checkpoint_save_s": t_save,
           "close_ms": close_ms, "k1_per_frame": per_frame,
           "sampler_counts": counts, "union_find": backend}
    if "prob" in seen:
        prob, kwargs = seen["prob"], seen["kwargs"]
        poses, c0, cf = fetch(seen["result"][0].poses,
                              seen["result"][1]["initial_cost"],
                              seen["result"][1]["final_cost"])
        s = np.exp(poses[:, 6]) if poses.shape[1] == 7 else np.ones(1)
        out["pose_graph"] = {
            "poses": list(prob.poses.shape), "edges": int(
                prob.edge_i.shape[0]), "dtype": str(prob.poses.dtype)[6:],
            "huber_delta": kwargs.get("huber_delta"),
            "cost": [float(c0), float(cf)],
            "scale_min": float(s.min()), "scale_max": float(s.max()),
            "scale_drift": float(s.max() / s.min() - 1.0)}
        _, out["pose_graph"]["optimize_ms"] = events_ms(
            lambda: optimize(prob, **kwargs), dev)
    log("loop", json.dumps(out), f"({card})")
    check(accepted >= n_frames - 1, f"loop: {accepted}/{n_frames} accepted")
    check(bool(closed) and any(e["kind"] == "metric"
                               for e in out["loop_edges"]),
          "loop: no verified metric loop edge")
    check(ate_after <= 1.05 * ate_before + 1e-6,
          f"loop: ATE {ate_before} -> {ate_after}")
    check(ate_after <= LOOP_ATE_GATE,
          f"loop: ATE after closure {ate_after} against the reference's "
          f"{LOOP_ATE_GATE}")
    check(bool(np.isfinite(traj).all() and np.isfinite(points).all()),
          "loop: non-finite pose graph or map")
    if dev.type == "cuda":
        check(per_frame >= 1 and counts == {
            "K1": n_frames * per_frame, "K1 general": 0, "K2": 0,
            "K2 general": 0, "index copies": 0},
            f"loop: expected {n_frames} x {per_frame} launches of K1's "
            f"vector variant and nothing else, got {counts}")

    # Checkpoint round trip into a fresh pipeline on the same device.
    path = str(tmp / "after_close.npz")
    save_sfm_state(path, pipe)
    t_load = time.perf_counter()
    fresh = load_sfm_state(path, OdometryPipeline(K, cfg, device=dev))
    out["checkpoint_load_s"] = time.perf_counter() - t_load
    prev = [torch.equal(a, b) and a.device == b.device for a, b in
            zip(fresh._prev_keypoints, pipe._prev_keypoints)]
    same = {"trajectory": bool(np.array_equal(fresh.trajectory(), traj)),
            "map": bool(np.array_equal(fresh.point_cloud.points, points)),
            "generator": bool(torch.equal(fresh._gen.get_state(),
                                          pipe._gen.get_state())),
            "prev_keypoints": all(prev), "frames": len(fresh.frames)
            == len(pipe.frames)}
    out["checkpoint"] = same
    log("loop: checkpoint round trip", json.dumps(same),
        f"load {out['checkpoint_load_s']:.2f} s")
    check(all(same.values()), f"loop: checkpoint round trip {same}")

    if dev.type == "cuda":
        # The same close again from the saved state: syncs, then a profile.
        def replay():
            p = load_sfm_state(str(tmp / "before_close.npz"),
                               OdometryPipeline(K, cfg, device=dev))
            c = replay_closer(closer, gen_state)
            return lambda: c.close(p, accepted - 1)

        out["close_syncs"] = count_syncs(replay())
        log("loop: host syncs in close", json.dumps(out["close_syncs"]))
        profile_frame(replay(), close_ms, top=15, what="loop close")
    for f in tmp.iterdir():
        f.unlink()
    tmp.rmdir()
    return out


SFM_SIZE = dict(n_views=128, n_points=900, capacity=512)  # bench_sfm_scale


def make_ring_scene(n_views: int, n_points: int, capacity: int,
                    noise: float = 0.3, seed: int = 1, device="cuda"):
    """scripts/bench_sfm_scale.py's ring scene, as its twin
    (``scripts/torch_bench_sfm_scale.py``) builds it: cameras on a ring of
    radius 18 looking at a central cloud of ``n_points`` points with
    planted descriptors, ``capacity`` keypoints per view (kept by point
    id), ``noise`` px of pixel noise. Returns (port Keypoints on
    ``device``, camera centres, K)."""
    return load_tool("bench_sfm_scale").make_ring_scene(
        n_views, n_points, capacity, noise, seed, device=device)


def _city_path(n_views: int):
    """scripts/bench_city_scale_scene.py::_path: camera centres, yaws and
    pitches of the boustrophedon street sweep (straight rows joined by
    smooth turn arcs)."""
    turn_views = 8
    row_len = max(8, int(np.ceil(n_views / np.sqrt(n_views))))
    centers, yaws, pitches = [], [], []
    pos = np.array([0.0, 0.0, 0.0])
    heading = 0.0
    f = 0
    while f < n_views:
        for _ in range(row_len):
            if f >= n_views:
                break
            d = np.array([np.sin(heading), 0.0, np.cos(heading)])
            pos = pos + d
            centers.append(pos.copy())
            yaws.append(heading + 0.1 * np.sin(0.7 * f))
            pitches.append(0.1 * np.sin(0.41 * f + 1.0))
            f += 1
        for _ in range(turn_views):
            if f >= n_views:
                break
            heading += np.pi / turn_views
            d = np.array([np.sin(heading), 0.0, np.cos(heading)])
            pos = pos + 0.8 * d
            centers.append(pos.copy())
            yaws.append(heading)
            pitches.append(0.1 * np.sin(0.41 * f + 1.0))
            f += 1
    return np.asarray(centers), np.asarray(yaws), np.asarray(pitches)


def _city_rot(yaw: float, pitch: float) -> np.ndarray:
    Ry = np.array([[np.cos(yaw), 0, -np.sin(yaw)], [0, 1, 0],
                   [np.sin(yaw), 0, np.cos(yaw)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                   [0, np.sin(pitch), np.cos(pitch)]])
    return Rx @ Ry


def make_city_scene(n_views: int, capacity: int = 384, pts_per_seg: int = 36,
                    noise: float = 0.3, seed: int = 3):
    """scripts/bench_city_scale_scene.py::make_city_scene in numpy: facade
    points ahead of each view of the street sweep, planted descriptors,
    each view keeping its first ``capacity`` visible point ids with
    ``noise`` px of pixel noise. Returns (per-view tuples of numpy
    Keypoints fields, camera centres, K, per-view point ids, rotations)."""
    rs = np.random.RandomState(seed)
    centers, yaws, pitches = _city_path(n_views)
    X = []
    for f in range(n_views):
        yaw = yaws[f]
        d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        side = np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
        local = np.stack([
            rs.uniform(-4, 4, pts_per_seg),
            rs.uniform(-2.5, 2.5, pts_per_seg),
            rs.uniform(2.0, 14.0, pts_per_seg),
        ], axis=1)
        X.append(centers[f][None] + local[:, 2:3] * d[None]
                 + local[:, 0:1] * side[None]
                 + local[:, 1:2] * np.array([0.0, 1.0, 0.0])[None])
    X = np.concatenate(X)
    desc = rs.normal(size=(len(X), 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    kps, ids, rots = [], [], []
    for f in range(n_views):
        R = _city_rot(yaws[f], pitches[f])
        t = -R @ centers[f]
        Xc = X @ R.T + t
        vis = (Xc[:, 2] > 1.0) & (Xc[:, 2] < 16.0)
        uv = Xc @ K.T
        uv = uv[:, :2] / np.where(vis, Xc[:, 2], 1.0)[:, None]
        inside = ((uv[:, 0] >= 0) & (uv[:, 0] < 640)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < 480))
        idx = np.nonzero(vis & inside)[0][:capacity]
        n = len(idx)
        xy = np.zeros((capacity, 2), np.float32)
        xy[:n] = uv[idx] + rs.normal(scale=noise, size=(n, 2))
        dsc = np.zeros((capacity, 128), np.float32)
        dsc[:n] = desc[idx]
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        kps.append((xy, np.full(capacity, 2.0, np.float32),
                    np.zeros(capacity, np.float32), mask.astype(np.float32),
                    dsc, mask))
        ids.append(idx)
        rots.append(R)
    return kps, centers, K, X, ids, np.stack(rots)


def city_pairs(centers, window: int = 3, radius: float = 7.0,
               gap: int = 12, max_loop_per_view: int = 2):
    """scripts/bench_city_scale_scene.py::proximity_pairs: sequential
    window pairs + loop pairs between close, temporally distant views."""
    V = len(centers)
    pairs = []
    for i in range(V):
        for j in range(i + 1, min(i + 1 + window, V)):
            pairs.append((i, j))
        d = np.linalg.norm(centers[i + gap:] - centers[i], axis=1)
        close = np.nonzero(d < radius)[0][:max_loop_per_view]
        for c in close:
            pairs.append((i, i + gap + int(c)))
    return sorted(set(pairs))


def city_ba_arrays(n_views: int, capacity: int = 384, seed: int = 0,
                   rot_sigma: float = 0.002, trans_sigma: float = 0.02,
                   point_sigma: float = 0.05) -> dict:
    """BASELINE config 5's BA problem from the city scene's true tracks:
    one observation per (view, kept point id) at the scene's noisy pixel
    (0.3 px), every point seen by at least two views, the ground-truth
    poses (angle-axis, world -> camera) and points perturbed from
    ``seed``; view 0 fixed. Returns numpy arrays (float64)."""
    from sara_tpu_torch.core import lie

    kps, centers, K, X, ids, rots = make_city_scene(n_views, capacity)
    cam = np.concatenate([np.full(len(i), f) for f, i in enumerate(ids)])
    pid = np.concatenate(ids)
    uv = np.concatenate([k[0][:len(i)] for k, i in zip(kps, ids)])
    counts = np.bincount(pid, minlength=len(X))
    tracked = np.nonzero(counts >= 2)[0]
    local = np.full(len(X), -1, np.int64)
    local[tracked] = np.arange(len(tracked))
    keep = local[pid] >= 0
    rs = np.random.RandomState(seed)
    w = lie.so3_log(torch.from_numpy(rots)).numpy()
    t = -np.einsum("vij,vj->vi", rots, centers)
    poses = np.concatenate([w, t], axis=1)
    poses[1:, :3] += rs.normal(scale=rot_sigma, size=(n_views - 1, 3))
    poses[1:, 3:] += rs.normal(scale=trans_sigma, size=(n_views - 1, 3))
    points = X[tracked] + rs.normal(scale=point_sigma,
                                    size=(len(tracked), 3))
    pose_fixed = np.zeros(n_views, bool)
    pose_fixed[0] = True
    return dict(poses=poses, points=points,
                intrinsics=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
                cam_idx=cam[keep].astype(np.int32),
                pt_idx=local[pid[keep]].astype(np.int32),
                uv=uv[keep].astype(np.float64),
                obs_mask=np.ones(int(keep.sum()), bool),
                pose_fixed=pose_fixed,
                point_fixed=np.zeros(len(tracked), bool))


def ring_rotations(n_views: int) -> np.ndarray:
    """The world -> camera rotations of make_ring_scene's views."""
    out = []
    for f in range(n_views):
        ang = 2 * np.pi * f / n_views
        c = np.array([18.0 * np.cos(ang), 2.0 * np.sin(3 * ang),
                      18.0 * np.sin(ang)])
        z = -c / np.linalg.norm(c)
        xax = np.cross(np.array([0.0, 1.0, 0.0]), z)
        xax /= np.linalg.norm(xax)
        out.append(np.stack([xax, np.cross(z, xax), z]))
    return np.stack(out)


def edge_errors_deg(edges, edge_R, edge_t, R_gt, centers_gt) -> dict:
    """Rotation and translation-direction errors (degrees) of the pair
    stage's edges against the ground truth: median, max and the count
    above 1 degree."""
    rot, dirs = [], []
    for (a, b), R, t in zip(edges, edge_R, edge_t):
        Rr = R_gt[b] @ R_gt[a].T
        c = np.clip((np.trace(Rr.T @ np.asarray(R)) - 1) / 2, -1, 1)
        rot.append(np.degrees(np.arccos(c)))
        tr = -R_gt[b] @ (centers_gt[b] - centers_gt[a])
        tr /= np.linalg.norm(tr)
        dirs.append(np.degrees(np.arccos(np.clip(
            float(np.dot(tr, t / np.linalg.norm(t))), -1, 1))))
    rot, dirs = np.asarray(rot), np.asarray(dirs)
    return {"rot": [float(np.median(rot)), float(rot.max()),
                    int((rot > 1).sum())],
            "dir": [float(np.median(dirs)), float(dirs.max()),
                    int((dirs > 1).sum())]}


def phase_global_sfm(card: str, device="cuda", size=None, window: int = 4,
                     chunk: int = 32, samples: int = 256,
                     ba_iters: int = 40) -> dict:
    """BASELINE config 4's building block at scripts/bench_sfm_scale.py's
    default size: the ring scene (128 views, 900 points, capacity 512, 0.3
    px), each view paired with the next ``window`` (502 pairs), through
    ``run_global_sfm`` with ``GlobalSfMConfig(rel_pose_samples=256,
    min_pair_inliers=20, pair_chunk=32, ba_options=BAOptions(max_iters=40))``.
    Gates: at least views - 1 edges, ATE <= 0.15 on the ring of radius 18,
    more than 500 points, the BA's final cost below its initial cost,
    everything finite. Records each stage's seconds, pairs/s and views/s,
    and on the card the host syncs and ms of one chunk
    of the batched pair stage (the first ``chunk`` pairs, their results
    fetched in one transfer) and a profile of stages 3-6 (averaging,
    polish, triangulation, BA) run again on the same epipolar graph.
    """
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm import global_sfm as gs
    from sara_tpu_torch.utils import ate_rmse
    from sara_tpu_torch.utils.host import fetch

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    kps, centers_gt, K = make_ring_scene(**(size or SFM_SIZE), device=dev)
    V = len(kps)
    pairs = [(i, j) for i in range(V)
             for j in range(i + 1, min(i + 1 + window, V))]
    cfg = gs.GlobalSfMConfig(rel_pose_samples=samples, min_pair_inliers=20,
                             pair_chunk=chunk,
                             ba_options=BAOptions(max_iters=ba_iters))
    sync()
    t0 = time.perf_counter()
    res = gs.run_global_sfm(kps, K, pairs=pairs, config=cfg, device=dev)
    total = time.perf_counter() - t0
    R, t, X = res["R"], res["t"], res["points"]
    centers = np.stack([-R[v].T @ t[v] for v in range(V)])
    ate = ate_rmse(centers, centers_gt)
    st = res["stage_times"]
    info = res["ba_info"]
    out = {"views": V, "pairs": len(pairs), "edges": res["num_edges"],
           "points": len(X), "observations": res["n_obs"], "ate": ate,
           "ring_radius": 18.0, "total_s": total, "stage_s": st,
           "pairs_per_s": len(pairs) / st["pair_stage"],
           "views_per_s": V / total,
           "ba_cost": [float(info["initial_cost"]),
                       float(info["final_cost"])],
           "ate_averaged": ate_rmse(res["centers_averaged"], centers_gt),
           "ate_polished": ate_rmse(res["centers_polished"], centers_gt),
           "edge_err_deg": edge_errors_deg(res["edges"], res["edge_R"],
                                           res["edge_t"], ring_rotations(V),
                                           centers_gt)}
    if dev.type == "cuda":
        stack = lambda name: torch.stack([getattr(k, name)   # noqa: E731
                                          for k in kps])
        xy, desc, msk = stack("xy"), stack("descriptors"), stack("mask")
        gen = torch.Generator(device=dev).manual_seed(0)
        Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
        first = pairs[:chunk]

        def one_chunk():
            return fetch(*gs._pair_chunk_program(
                xy, desc, msk, [p[0] for p in first], [p[1] for p in first],
                gen, Kt, cfg.match_ratio, cfg.rel_pose_threshold_px,
                cfg.rel_pose_samples, cfg.min_pair_inliers))

        out["chunk_pairs"] = len(first)
        out["chunk_ms"] = timed_call_ms(one_chunk, dev)
        out["chunk_syncs"] = count_syncs(one_chunk)
        xy_host = fetch(*[k.xy for k in kps])

        def stages():
            return gs._global_stages(V, K, cfg, dev, res["tracker"], xy_host,
                                     res["edges"], res["edge_R"],
                                     res["edge_t"], res["edge_feats"],
                                     lambda name: None)

        sync()
        t1 = time.perf_counter()
        stages()
        sync()
        out["stages_3_6_ms"] = (time.perf_counter() - t1) * 1e3
    log("global_sfm", json.dumps(out), f"({card})")
    check(res["num_edges"] >= V - 1, f"global_sfm: {res['num_edges']} edges")
    check(ate <= 0.15, f"global_sfm: ATE {ate}")
    check(len(X) > 500, f"global_sfm: {len(X)} points")
    check(out["ba_cost"][1] < out["ba_cost"][0],
          f"global_sfm: BA cost {out['ba_cost']}")
    check(bool(np.isfinite(R).all() and np.isfinite(t).all()
               and np.isfinite(X).all()), "global_sfm: non-finite output")
    if dev.type == "cuda":
        profile_frame(stages, out["stages_3_6_ms"], top=15,
                      what="global sfm stages 3-6")
    return out


def phase_low_precision(ps, card: str) -> tuple:
    """F2: the frontend's two branches on the 480x640 frame pair of phase
    4: float32 orientation maps at stride 1 (the default) against bfloat16
    maps at stride 2 (``SIFTParams(low_precision=True)``). For each: the
    frontend ms per frame (median of 5 after a warm-up), the device's busy
    ms (a profile), K1's launches by variant and dtype path, K1's summed
    device ms over frame A's launches, the matches and their recall on the
    16-px shift (on-shift matches over A's keypoints whose shifted
    position lies in B). Every K1 output of the counted run is held
    against the plain version on the same card tensors (max abs error
    <= TOLERANCE). Gates: both branches give finite keypoints and >= 90%
    on-shift precision; every K1 launch is the vector variant. Returns
    (the record, K1's launches in both runs, K1's worst error)."""
    from sara_tpu_torch.features import api
    from sara_tpu_torch.matching.brute_force import (MatchParams,
                                                     match_descriptors)

    h, w = FRAME_HW
    tex = texture(1, h, w + SHIFT_PX)
    frame_a, frame_b = tex[:, SHIFT_PX:], tex[:, :w]
    out = {}
    wrapper = ps.sample_field_patches
    for name, low in (("f32_ds1", False), ("bf16_ds2", True)):
        params = api.SIFTParams(desc_sampler="kernel",
                                desc_sample_nearest=False, low_precision=low)
        api.compute_sift_keypoints(frame_a, params)            # warm-up
        torch.cuda.synchronize()
        recorded = []

        def recording(*args, **kwargs):
            result = wrapper(*args, **kwargs)
            recorded.append((args, kwargs, result))
            return result

        ps.sample_field_patches = recording
        try:
            ps.reset_counts()
            ka = api.compute_sift_keypoints(frame_a, params)
            kb = api.compute_sift_keypoints(frame_b, params)
            m = match_descriptors(ka, kb, MatchParams(ratio=0.8))
            torch.cuda.synchronize()
            counts = ps.counts()
        finally:
            ps.sample_field_patches = wrapper
        errs = []
        for (maps, s_idx, ys, xs), _, got in recorded:
            ref = ps._sample_patches_reference(maps, s_idx, ys, xs)
            check(got.shape == ref.shape,
                  f"low precision {name}: shape {tuple(got.shape)}")
            errs.append((got - ref).abs().max().item())
        shapes = sorted({tuple(a[0].shape) for a, _, _ in recorded})
        log(f"K1 vector vs plain [low precision {name}] {len(errs)} calls "
            f"on {shapes}: max_abs_err={max(errs):.3e}")
        check(max(errs) <= TOLERANCE,
              f"low precision {name}: K1 vs plain {max(errs)}")
        frame_ms = timed_call_ms(
            lambda: api.compute_sift_keypoints(frame_a, params),
            torch.device("cuda"))
        prof = profile_frame(
            lambda: api.compute_sift_keypoints(frame_a, params),
            frame_ms, top=8, what=f"frontend {name}")
        busy = prof and prof["device_busy_ms"]
        k1_ms = sum(timed_ms(lambda a=a, k=k: ps.sample_field_patches(
            *a, **k)) for a, k, _ in recorded[:len(recorded) // 2])
        n_match = int(m.count())
        i, j = m.i[m.mask].long(), m.j[m.mask].long()
        d = kb.xy[j] - ka.xy[i]
        on = int((((d[:, 0] - SHIFT_PX).abs() <= 1)
                  & (d[:, 1].abs() <= 1)).sum())
        present = int((ka.mask & (ka.xy[:, 0] + SHIFT_PX <= w - 1)).sum())
        out[name] = {
            "maps_dtype": str(recorded[0][0][0].dtype),
            "frame_ms": frame_ms, "busy_ms": busy,
            "keypoints": [int(ka.count()), int(kb.count())],
            "matches": n_match, "on_shift": on,
            "precision": on / max(n_match, 1),
            "recall": on / max(present, 1),
            "k1_launches": counts, "k1_frame_ms": k1_ms,
            "k1_max_abs_err": max(errs)}
        check(bool(torch.isfinite(ka.descriptors).all()
                   and torch.isfinite(ka.xy).all()),
              f"low precision {name}: non-finite keypoints")
        check(on >= 0.9 * n_match and n_match >= 100,
              f"low precision {name}: {on} of {n_match} on the shift")
        check(counts["K1"] == len(recorded) and counts["K1 general"] == 0,
              f"low precision {name}: K1 counts {counts}")
    check(out["bf16_ds2"]["maps_dtype"] == "torch.bfloat16"
          and out["f32_ds1"]["maps_dtype"] == "torch.float32",
          f"low precision: map dtypes {out}")
    log("low_precision", json.dumps(out), f"({card})")
    return (out, sum(out[b]["k1_launches"]["K1"] for b in out),
            max(out[b]["k1_max_abs_err"] for b in out))


CITY_SIZE = dict(n_views=1024, capacity=384)   # scripts/bench_city_scale.py
# Cut: 2 sweeps where bench_city_scale.py runs 3 (--ba-sweeps), here and
# in phase "dist", which repeats the solve on a mesh; with 3 the whole
# script took 791 s of its 1200 s limit on the H100.
CITY_BA = dict(blocks=16, sweeps=2, iters=12, global_iters=36)
CITY_SFM_VIEWS = 256


def _problem_on(arrays: dict, device, dtype=torch.float32):
    """A port BAProblem on ``device`` from numpy arrays."""
    from sara_tpu_torch.ba import BAProblem

    f = lambda k: torch.as_tensor(arrays[k], dtype=dtype).to(device)  # noqa
    t = lambda k: torch.as_tensor(arrays[k]).to(device)              # noqa
    return BAProblem(poses=f("poses"), points=f("points"),
                     intrinsics=f("intrinsics"), cam_idx=t("cam_idx"),
                     pt_idx=t("pt_idx"), uv=f("uv"), obs_mask=t("obs_mask"),
                     pose_fixed=t("pose_fixed"),
                     point_fixed=t("point_fixed"))


def phase_city(card: str, device="cuda", size=None, ba=None,
               sfm_views: int = CITY_SFM_VIEWS) -> dict:
    """BASELINE config 5's BA at scripts/bench_city_scale.py's defaults: the
    city scene (1024 views, capacity 384) in numpy, its true tracks as a BA
    problem (poses and points perturbed from seed 0, the scene's 0.3 px
    noise kept), float32, through ``partitioned_bundle_adjust`` (16 blocks,
    2 sweeps: a cut, ``CITY_BA``; 12 LM iterations) and the global
    ``bundle_adjust`` (C > 512: the CG path) at 36 LM iterations. Gates:
    both lower the cost, the partitioned cost is at most the initial one,
    every output finite.
    Records the ratio of the partitioned cost to the global one (the
    reference's target: 1.3), Cb, Pb, Sp, the point chunk, seconds per
    phase and per sweep, syncs of one phase, peak memory. Then
    ``run_global_sfm`` on ``sfm_views`` views of the scene with
    ``ba_blocks=8, ba_sweeps=3`` and a "block" mesh (a world of one:
    NCCL on the card): edges, ATE, points, stage seconds.
    Returns the problem and the partitioned result for phase "dist"."""
    from sara_tpu_torch.ba import BAOptions, ba_cost, bundle_adjust
    from sara_tpu_torch.ba import partitioned as part
    from sara_tpu_torch.core.types import Keypoints
    from sara_tpu_torch.parallel import make_mesh
    from sara_tpu_torch.sfm import global_sfm as gs
    from sara_tpu_torch.utils import ate_rmse

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size = size or CITY_SIZE
    ba = ba or CITY_BA
    t0 = time.perf_counter()
    arrays = city_ba_arrays(**size)
    prob = _problem_on(arrays, dev)
    out = {"size": size, "ba": ba, "cameras": len(arrays["poses"]),
           "points": len(arrays["points"]),
           "observations": len(arrays["uv"]),
           "max_track": int(np.bincount(arrays["pt_idx"]).max()),
           "build_s": time.perf_counter() - t0}
    plan = part.plan_blocks(prob, ba["blocks"])
    out["Cb"], out["Pb"] = plan.cam_local.shape[1], plan.pt_local.shape[1]
    cam_blk = plan.block_of_cam[arrays["cam_idx"]]
    pt_blk = plan.block_of_pt[arrays["pt_idx"]]
    out["block_cameras"] = [int(len(np.union1d(
        np.nonzero(plan.block_of_cam == b)[0],
        arrays["cam_idx"][(cam_blk == b) | (pt_blk == b)])))
        for b in range(ba["blocks"])]
    out["block_points"] = [int(v.sum()) for v in plan.pt_valid]
    opts = BAOptions(max_iters=ba["iters"])
    log(f"city: {ba['sweeps']} partitioned sweeps (cut; "
        "bench_city_scale.py: 3)")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    pres, pinfo = part.partitioned_bundle_adjust(prob, ba["blocks"], opts,
                                                 sweeps=ba["sweeps"])
    sync()
    out["partitioned_s"] = time.perf_counter() - t0
    out["Sp"], out["chunk"] = pinfo["sp"], pinfo["chunk"]
    out["phase_s"] = pinfo["phase_s"]
    n_ph = len(pinfo["phase_s"]) // ba["sweeps"]
    out["sweep_s"] = [sum(pinfo["phase_s"][k * n_ph:(k + 1) * n_ph])
                      for k in range(ba["sweeps"])]
    if cuda:
        out["partitioned_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    gres, ginfo = bundle_adjust(prob, BAOptions(max_iters=ba["global_iters"]))
    sync()
    out["global_s"] = time.perf_counter() - t0
    if cuda:
        out["global_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["syncs_one_phase"] = count_syncs(
            lambda: part.partitioned_bundle_adjust(
                prob, 2, BAOptions(max_iters=1), sweeps=1))
    c0, cp, cg = (float(ba_cost(p, 4.0, 6.0)) for p in (prob, pres, gres))
    out.update(initial_cost=c0, partitioned_cost=cp, global_cost=cg,
               ratio_to_global=cp / cg,
               global_info=[float(ginfo["initial_cost"]),
                            float(ginfo["final_cost"])],
               partitioned_info=[float(pinfo["initial_cost"]),
                                 float(pinfo["final_cost"])])
    log("city ba", json.dumps(out), f"({card})")
    check(cp <= c0 and cp < c0, f"city: partitioned cost {cp} vs {c0}")
    check(out["global_info"][1] < out["global_info"][0],
          f"city: global cost {out['global_info']}")
    for name, p in (("partitioned", pres), ("global", gres)):
        check(bool(torch.isfinite(p.poses).all()
                   and torch.isfinite(p.points).all()),
              f"city: non-finite {name} result")

    # The whole pipeline on the first sfm_views views of the scene.
    kps_np, centers_gt, K, _, _, _ = make_city_scene(sfm_views,
                                                     size["capacity"])
    kps = [Keypoints(*(torch.from_numpy(a).to(dev) for a in k))
           for k in kps_np]
    pairs = city_pairs(centers_gt)
    cfg = gs.GlobalSfMConfig(rel_pose_samples=192, min_pair_inliers=20,
                             pair_chunk=32,
                             ba_options=BAOptions(max_iters=ba["iters"]),
                             ba_blocks=8, ba_sweeps=3)
    sync()
    t0 = time.perf_counter()
    res = gs.run_global_sfm(kps, K, pairs=pairs, config=cfg,
                            ba_mesh=make_mesh(axis="block", device=dev),
                            device=dev)
    total = time.perf_counter() - t0
    V = sfm_views
    centers = np.stack([-res["R"][v].T @ res["t"][v] for v in range(V)])
    sfm = {"views": V, "pairs": len(pairs), "edges": res["num_edges"],
           "points": len(res["points"]), "observations": res["n_obs"],
           "ate": ate_rmse(centers, centers_gt),
           "path_length": float(np.linalg.norm(
               np.diff(centers_gt, axis=0), axis=1).sum()),
           "total_s": total, "stage_s": res["stage_times"],
           "pairs_per_s": len(pairs) / res["stage_times"]["pair_stage"],
           "ba_cost": [float(res["ba_info"]["initial_cost"]),
                       float(res["ba_info"]["final_cost"])]}
    out["global_sfm"] = sfm
    log("city global_sfm", json.dumps(sfm), f"({card})")
    check(res["num_edges"] >= V - 1, f"city sfm: {res['num_edges']} edges")
    check(bool(np.isfinite(res["R"]).all() and np.isfinite(res["t"]).all()
               and np.isfinite(res["points"]).all()),
          "city sfm: non-finite output")
    check(sfm["ate"] < 2.0 and sfm["points"] > 500,
          f"city sfm: ATE {sfm['ate']}, {sfm['points']} points")
    return out, prob, pres


def phase_dist(card: str, city_prob, city_part, frames, device="cuda",
               size=None, iters: int = 10) -> dict:
    """Slice D2's distributed solvers on a world of one under NCCL on the
    card (one H100 gives one rank; no scaling across GPUs is measured).
    ``dense_schur_bundle_adjust_sharded`` on phase "ba"'s problem (C=256,
    P=100k, O=800k, float32, ``iters`` LM iterations) against the
    unsharded loop on the same packing: costs within 1e-5 relative.
    ``distributed_bundle_adjust(solver="cg")`` against
    ``bundle_adjust_cg``: final costs within 1e-5 relative.
    ``partitioned_bundle_adjust(mesh=...)`` on phase "city"'s problem
    against its unmeshed result: equal within 1e-6 relative.
    ``batched_match_pairs`` on 8 descriptor-set pairs cut from the frame
    pair against ``match_descriptors`` pair by pair: equal matches.
    Records the NCCL all-reduce ms of one LM iteration's payload and ms
    per iteration of each solver."""
    import torch.distributed as dist

    from sara_tpu_torch.ba import BAOptions, bundle_adjust_cg
    from sara_tpu_torch.ba import dense_schur, partitioned as part
    from sara_tpu_torch.core.types import Keypoints
    from sara_tpu_torch.matching.brute_force import (MatchParams,
                                                     match_descriptors)
    from sara_tpu_torch.parallel import (batched_match_pairs,
                                         distributed_bundle_adjust,
                                         make_mesh)

    dev = torch.device(device)
    mesh = make_mesh(device=dev)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    check(out["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
          and out["world"] == 1, f"dist: process group {out}")
    prob = make_ba_problem(**(size or BA_SIZE), device=dev)
    opts = BAOptions(max_iters=iters)
    ptm, stats = dense_schur.pack_pt_major(
        prob, chunk=min(opts.dense_chunk, max(64, prob.points.shape[0])))
    Q = stats["chunk"]
    dense_schur.dense_schur_bundle_adjust(ptm, BAOptions(max_iters=1), Q)
    (_, _, ref), ref_ms = events_ms(
        lambda: dense_schur.dense_schur_bundle_adjust(ptm, opts, Q), dev)
    (_, _, sh), sh_ms = events_ms(
        lambda: dense_schur.dense_schur_bundle_adjust_sharded(
            ptm, mesh, opts, Q), dev)
    rc, sc = ref["costs"].double(), sh["costs"].double()
    out["dense"] = {"ms_per_iter": ref_ms / iters,
                    "sharded_ms_per_iter": sh_ms / iters,
                    "final_cost": [float(ref["final_cost"]),
                                   float(sh["final_cost"])],
                    "max_rel_cost_diff": float(((sc - rc).abs()
                                                / rc.abs()).max())}
    cg_opts = BAOptions(max_iters=iters, cg_iters=15, solver="cg")
    (_, ci), cg_ms = events_ms(lambda: bundle_adjust_cg(prob, cg_opts), dev)
    (_, di), dcg_ms = events_ms(
        lambda: distributed_bundle_adjust(prob, mesh, cg_opts), dev)
    out["cg"] = {"ms_per_iter": cg_ms / iters,
                 "sharded_ms_per_iter": dcg_ms / iters,
                 "final_cost": [float(ci["final_cost"]),
                                float(di["final_cost"])]}
    out["cg"]["rel_diff"] = (abs(out["cg"]["final_cost"][1]
                                 - out["cg"]["final_cost"][0])
                             / out["cg"]["final_cost"][0])
    # The all-reduce payload of one dense LM iteration.
    C = prob.poses.shape[0]
    payload = [torch.randn(n, device=dev) for n in
               ((6 * C) ** 2, 42 * C, 6 * C, 1, 1)]
    out["allreduce_ms_per_iter"] = timed_ms(
        lambda: [dist.all_reduce(x, group=mesh.get_group()) for x in payload]
    ) if dev.type == "cuda" else None
    out["allreduce_mb_per_iter"] = sum(x.numel() for x in payload) * 4 / 1e6

    # The partitioned solve with its blocks on the mesh.
    log(f"dist: the meshed partitioned solve at phase city's depth, "
        f"{CITY_BA['sweeps']} sweeps (cut; bench_city_scale.py: 3)")
    blk = make_mesh(device=dev, axis="block")
    t0 = time.perf_counter()
    meshed, _ = part.partitioned_bundle_adjust(
        city_prob, CITY_BA["blocks"], BAOptions(max_iters=CITY_BA["iters"]),
        sweeps=CITY_BA["sweeps"], mesh=blk)
    out["partitioned_mesh_s"] = time.perf_counter() - t0
    diff = max(float((meshed.poses - city_part.poses).abs().max()
                     / city_part.poses.abs().max()),
               float((meshed.points - city_part.points).abs().max()
                     / city_part.points.abs().max()))
    out["partitioned_mesh_rel_diff"] = diff

    # Batched matching: 8 pairs of 1024-row descriptor sets.
    ka, kb = frames[0], frames[1]
    B = 8
    da = ka.descriptors.reshape(B, -1, 128)
    db = kb.descriptors.reshape(B, -1, 128)
    ma, mb = ka.mask.reshape(B, -1), kb.mask.reshape(B, -1)
    j, ok, _ = batched_match_pairs(da, ma, db, mb, mesh, ratio=0.8)
    same = 0
    for b in range(B):
        n = da.shape[1]
        z = torch.zeros(n, device=dev)
        m = match_descriptors(Keypoints(z[:, None].expand(n, 2), z, z, z,
                                        da[b], ma[b]),
                              Keypoints(z[:, None].expand(n, 2), z, z, z,
                                        db[b], mb[b]),
                              MatchParams(ratio=0.8), device=dev)
        same += int(torch.equal(m.mask, ok[b]) and torch.equal(
            torch.where(m.mask, m.j, -1), torch.where(ok[b], j[b], -1)))
    out["match_pairs_equal"] = same
    out["match_count"] = int(ok.sum())
    log("dist", json.dumps(out), f"({card})")
    check(out["dense"]["max_rel_cost_diff"] <= 1e-5,
          f"dist: sharded dense costs {out['dense']}")
    check(out["cg"]["rel_diff"] <= 1e-5, f"dist: sharded CG {out['cg']}")
    check(diff <= 1e-6, f"dist: meshed partitioned differs by {diff}")
    check(same == B and out["match_count"] > 0,
          f"dist: batched matching equal on {same} of {B} pairs")
    return out


CALIB_HW = (720, 1280)           # a 720p camera, as a user of the CLI films
CALIB_BOARD = (6, 9)             # inner corners (rows, cols)
CALIB_K = np.array([[1000.0, 0, 640.0], [0, 1000.0, 360.0], [0, 0, 1.0]])
CALIB_VIEWS = 20


def render_chessboard(K, R, t, rows=5, cols=7, square=1.0, hw=(240, 320),
                      ss=3, device="cpu"):
    """tests/test_calibration.py::_render_chessboard (that file imports
    JAX), in float64 torch on ``device`` in bands of rows: a (rows+1) x
    (cols+1)-square board through the plane-to-image homography,
    supersampled ``ss`` x ``ss`` per pixel. Returns (float32 image,
    inner-corner pixels (rows, cols, 2), object points (rows, cols, 2)) as
    numpy arrays."""
    H, W = hw
    Hmat = K @ np.stack([R[:, 0], R[:, 1], t], axis=1)
    Hinv = torch.as_tensor(np.linalg.inv(Hmat), device=device)
    xs = (torch.arange(W * ss, dtype=torch.float64, device=device) + 0.5) \
        / ss - 0.5
    img = torch.empty((H, W), dtype=torch.float64, device=device)
    band = 48
    for y0 in range(0, H, band):
        h = min(band, H - y0)
        ys = (torch.arange(y0 * ss, (y0 + h) * ss, dtype=torch.float64,
                           device=device) + 0.5) / ss - 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        q = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1) @ Hinv.T
        X = q[..., 0] / q[..., 2]
        Y = q[..., 1] / q[..., 2]
        inside = ((X >= 0) & (X <= (cols + 1) * square)
                  & (Y >= 0) & (Y <= (rows + 1) * square))
        checker = torch.remainder(torch.floor(X / square)
                                  + torch.floor(Y / square), 2)
        v = torch.where(inside, checker, torch.ones_like(checker))
        img[y0:y0 + h] = v.reshape(h, ss, W, ss).mean(dim=(1, 3))
    jj, ii = np.meshgrid(np.arange(1, cols + 1), np.arange(1, rows + 1))
    obj = np.stack([jj * square, ii * square], axis=-1).astype(float)
    P = np.concatenate([obj.reshape(-1, 2), np.ones((rows * cols, 1))],
                       axis=1) @ Hmat.T
    return (img.to(torch.float32).cpu().numpy(),
            (P[:, :2] / P[:, 2:]).reshape(rows, cols, 2), obj)


def board_pose(yaw, pitch, rows, cols, distance):
    """World -> camera (R, t) of a board turned by ``yaw`` and ``pitch``
    whose centre lies ``distance`` in front of the camera, on its axis."""
    cy_, sy_, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    R = (np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
         @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    centre = np.array([(cols + 1) / 2.0, (rows + 1) / 2.0, 0.0])
    return R, np.array([0.0, 0.0, distance]) - R @ centre


def calib_views(n=CALIB_VIEWS, seed=0, device="cpu"):
    """``n`` 1280x720 views of the 6x9 board with K = (1000, 1000, 640,
    360): yaw and pitch on a 5 x 4 grid over +-35 degrees with a seeded
    jitter, the board's centre at distance 12 to 17 squares, rendered with
    6 x 6 samples per pixel on ``device`` (3 x 3, the reference test's,
    leaves up to 0.3 px of aliasing in the corners at this size)."""
    rs = np.random.RandomState(seed)
    rows, cols = CALIB_BOARD
    yaws = np.radians(np.linspace(-35, 35, 5))
    pitches = np.radians(np.linspace(-35, 35, 4))
    out = []
    for k in range(n):
        yaw = yaws[k % 5] + np.radians(rs.uniform(-2, 2))
        pitch = pitches[(k // 5) % 4] + np.radians(rs.uniform(-2, 2))
        R, t = board_pose(yaw, pitch, rows, cols, rs.uniform(12, 17))
        img, pix, _ = render_chessboard(CALIB_K, R, t, rows, cols,
                                        hw=CALIB_HW, ss=6, device=device)
        out.append((img, pix))
    return out


def barrel_warp(img, k1=-0.30, f=800.0):
    """dst(q) = src(c + (q - c)(1 + k1 |q - c|^2 / f^2)), bilinear with
    replicated borders (cv2.remap's INTER_LINEAR / BORDER_REPLICATE, in
    numpy), and the map of an undistorted pixel to its distorted place."""
    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    r2 = ((xs - cx) / f) ** 2 + ((ys - cy) / f) ** 2
    mx = np.clip(cx + (xs - cx) * (1 + k1 * r2), 0, w - 1)
    my = np.clip(cy + (ys - cy) * (1 + k1 * r2), 0, h - 1)
    x0 = np.minimum(np.floor(mx).astype(int), w - 2)
    y0 = np.minimum(np.floor(my).astype(int), h - 2)
    fx, fy = mx - x0, my - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)

    def forward(p):
        q = p.copy()
        for _ in range(30):
            n = (q - [cx, cy]) / f
            q = np.array([cx, cy]) + (p - [cx, cy]) / (1 + k1 * (n * n).sum())
        return q
    return out.astype(np.float32), forward


def omni_views(xi=0.8, n=CALIB_VIEWS, seed=1):
    """Planar views projected through the unified model [fx fy cx cy k1 k2
    xi] = [1800, 1800, 640, 360, 0, 0, xi] of a 7x9 grid of 1.5-unit
    squares held close (wide view angles, where xi is observable), poses
    spread over +-25 degrees. Returns (object points (n, 63, 2), pixels
    (n, 63, 2)) in float64."""
    from sara_tpu_torch.calib.calibrate import _project_omni
    from sara_tpu_torch.core import lie

    rs = np.random.RandomState(seed)
    intr = torch.tensor([1800.0, 1800.0, 640.0, 360.0, 0.0, 0.0, xi],
                        dtype=torch.float64)
    jj, ii = np.meshgrid(np.arange(1, 10), np.arange(1, 8))
    obj = np.stack([jj, ii], axis=-1).reshape(-1, 2).astype(float) * 1.5
    X = torch.from_numpy(np.concatenate([obj, np.zeros((len(obj), 1))],
                                        1))[None]
    objs, imgs = [], []
    for _ in range(n):
        yaw, pitch = np.radians(rs.uniform(-25, 25, 2))
        R, t = board_pose(yaw, pitch, 6, 8, rs.uniform(5.0, 7.0))
        t = t * 1.5                       # the grid's 1.5-unit squares
        w = lie.so3_log(torch.from_numpy(R)).numpy()
        p6 = torch.from_numpy(np.concatenate([w, t]))[None]
        imgs.append(_project_omni(intr, p6, X)[0].numpy())
        objs.append(obj)
    return np.stack(objs), np.stack(imgs)


def phase_calib(card: str, device="cuda", n_views: int = CALIB_VIEWS) -> dict:
    """Slice E end to end, as ``python -m sara_tpu_torch.calib.cli`` runs
    it (its ``collect_views`` and ``calibrate_views``; its image readers
    need PIL, which this machine lacks, so the frames are rendered in
    numpy): ``n_views`` 1280x720 views of a 6x9-inner-corner board, K =
    (1000, 1000, 640, 360), yaw and pitch over +-35 degrees. Gates: every
    view gives a (6, 9) grid, every corner within 0.3 px of the truth;
    the pinhole calibration recovers fx and fy within 0.5%, cx and cy
    within 2 px, RMS < 0.1 px; a strongly barrel-warped view yields the
    full grid through the squares fallback, every corner within 0.7 px;
    ``calibrate_omnidirectional`` recovers xi = 0.8 within 0.1 on 20
    planar views through the unified model; on the card, one view's
    ``_corner_candidates`` equals the CPU's within 1e-3 px with the same
    mask, and the float32 calibration (the twin's production dtype) is
    held to the float64 one (fx, fy, cx, cy within 1e-3 relative, RMS
    within 1e-3 px); everything finite. Records ms per view split into the
    device program, ``_assemble_grid`` and the squares fallback, ms of the
    LM, host syncs per view and a profile of one view's device program."""
    from sara_tpu_torch.calib import calibrate as cal
    from sara_tpu_torch.calib import chessboard as cb
    from sara_tpu_torch.calib import cli
    from sara_tpu_torch.calib.squares import assemble_grid_from_squares
    from sara_tpu_torch.utils.host import fetch, put

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    rows, cols = CALIB_BOARD
    t0 = time.perf_counter()
    views = calib_views(n_views, device=dev)
    out = {"views": n_views, "hw": list(CALIB_HW), "board": [rows, cols],
           "render_s": time.perf_counter() - t0}

    # The CLI's path: detect every view, then one joint calibration. The
    # first detection and the first LM (lazy library loads, cuDNN's
    # algorithm search) are timed apart.
    sync()
    t0 = time.perf_counter()
    cb.detect_chessboard_corners(views[0][0], device=dev)
    sync()
    out["first_detect_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    corners = cli.collect_views(((f"view{k}", img) for k, (img, _) in
                                 enumerate(views)), rows, cols,
                                max_views=n_views, device=dev)
    sync()
    out["detect_ms_per_view"] = (time.perf_counter() - t0) * 1e3 / n_views
    check(len(corners) == n_views,
          f"calib: {len(corners)} of {n_views} views gave a (6, 9) grid")
    err = [np.linalg.norm(c[:, None] - pix.reshape(-1, 2)[None], axis=-1)
           .min(0).max() for c, (_, pix) in zip(corners, views)]
    out["corner_err_px_max"] = float(max(err))
    t0 = time.perf_counter()
    res = cli.calibrate_views(corners, rows, cols, device=dev)
    out["first_calibration_ms"] = (time.perf_counter() - t0) * 1e3
    out["calibration_ms"] = timed_call_ms(
        lambda: cli.calibrate_views(corners, rows, cols, device=dev), dev,
        reps=3)
    K = res["K"]
    model = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                     axis=-1).reshape(-1, 2).astype(np.float64)
    obj = np.broadcast_to(model, (len(corners),) + model.shape).copy()
    K0, obj_t, img_t, poses0, on = cal._lm_inputs(obj, np.stack(corners),
                                                  dev)
    intr0 = on([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0.0])
    out["lm_ms"] = timed_call_ms(lambda: fetch(*cal._refine(
        intr0, poses0, obj_t, img_t, iters=30)), dev, reps=3)
    out["K"] = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                float(K[1, 2])]
    out["dist"] = [float(v) for v in res["dist"]]
    out["rms"] = res["rms"]
    # The twin's production dtype: the same corners in float32.
    res32 = cli.calibrate_views([c.astype(np.float32) for c in corners],
                                rows, cols, device=dev)
    out["K_f32"] = [float(res32["K"][i, j])
                    for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))]
    out["rms_f32"] = res32["rms"]

    # The split of one view: device program (+ its one fetch), the lattice
    # BFS, and the squares fallback run on the same candidates.
    img = views[0][0]
    params = cb.ChessboardParams()

    def program():
        o = cb._corner_candidates(put(img, dev), params)
        return fetch(o["mask"], o["x"], o["y"])

    m, xs, ys = program()
    pts = np.stack([xs[m], ys[m]], axis=1)
    out["device_program_ms"] = timed_call_ms(program, dev)
    t0 = time.perf_counter()
    for _ in range(5):
        cb._assemble_grid(pts)
    out["assemble_grid_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    out["squares_fallback_ms"] = timed_call_ms(
        lambda: assemble_grid_from_squares(img, pts, device=dev), dev, reps=3)
    out["detect_view_ms"] = timed_call_ms(
        lambda: cb.detect_chessboard_corners(img, device=dev), dev)
    if dev.type == "cuda":
        out["syncs_per_view"] = count_syncs(
            lambda: cb.detect_chessboard_corners(img, device=dev))
        # One view's device program on the card against the CPU's.
        oc = cb._corner_candidates(torch.from_numpy(img), params)
        mc = oc["mask"].numpy()
        pc = np.stack([oc["x"].numpy()[mc], oc["y"].numpy()[mc]], axis=1)
        d = np.linalg.norm(pts[:, None] - pc[None], axis=-1)
        out["card_vs_cpu_px"] = float(max(d.min(1).max(), d.min(0).max()))
        check(len(pc) == len(pts) and out["card_vs_cpu_px"] <= 1e-3,
              f"calib: card vs CPU candidates {len(pts)} / {len(pc)}, "
              f"{out['card_vs_cpu_px']} px")

    # The squares fallback under a strong barrel warp.
    R, t = board_pose(np.radians(12.0), np.radians(8.0), rows, cols, 12.0)
    img_u, pix_u, _ = render_chessboard(CALIB_K, R, t, rows, cols,
                                        hw=CALIB_HW, ss=6, device=dev)
    dimg, forward = barrel_warp(img_u)
    gt_d = np.stack([forward(p) for p in pix_u.reshape(-1, 2)])
    o = cb._corner_candidates(put(dimg, dev), params)
    m, xs, ys = fetch(o["mask"], o["x"], o["y"])
    dpts = np.stack([xs[m], ys[m]], axis=1)
    bfs = cb._assemble_grid(dpts)
    out["distorted_bfs_grid"] = None if bfs is None else list(bfs.shape[:2])
    grid = assemble_grid_from_squares(dimg, dpts, device=dev)
    check(grid is not None and sorted(grid.shape[:2]) == [rows, cols],
          f"calib: squares fallback grid "
          f"{None if grid is None else grid.shape}")
    derr = np.linalg.norm(grid.reshape(-1, 2)[:, None] - gt_d[None],
                          axis=-1).min(0).max()
    out["distorted_corner_err_px_max"] = float(derr)

    # The unified (omnidirectional) model.
    O, I = omni_views()
    t0 = time.perf_counter()
    omni = cal.calibrate_omnidirectional(O, I, device=dev)
    out["omni_ms"] = (time.perf_counter() - t0) * 1e3
    out["omni_xi"] = omni["xi"]
    out["omni_rms"] = omni["rms"]
    log("calib", json.dumps(out), f"({card})")

    check(out["corner_err_px_max"] <= 0.3,
          f"calib: corner error {out['corner_err_px_max']} px")
    fx, fy, cx, cy = out["K"]
    check(abs(fx - 1000) <= 5 and abs(fy - 1000) <= 5,
          f"calib: fx, fy = {fx}, {fy}")
    check(abs(cx - 640) <= 2 and abs(cy - 360) <= 2,
          f"calib: cx, cy = {cx}, {cy}")
    check(out["rms"] < 0.1, f"calib: RMS {out['rms']}")
    check(np.allclose(out["K_f32"], out["K"], rtol=1e-3, atol=0)
          and abs(out["rms_f32"] - out["rms"]) <= 1e-3,
          f"calib: float32 {out['K_f32']} {out['rms_f32']} vs float64")
    check(derr <= 0.7, f"calib: distorted corner error {derr} px")
    check(abs(out["omni_xi"] - 0.8) <= 0.1, f"calib: xi {out['omni_xi']}")
    check(all(np.isfinite(v) for v in out["K"] + out["dist"] + out["K_f32"]
              + [out["rms"], out["omni_xi"], out["omni_rms"]])
          and all(np.isfinite(c).all() for c in corners),
          "calib: non-finite output")
    if dev.type == "cuda":
        profile_frame(program, out["device_program_ms"], top=10,
                      what="calib device program (one view)")
    return out


# --- Slice F: detection and tracking, the feature and matching extras ----

DETECT_HW = 416                  # yolov4-tiny's published input size
DETECT_BATCHES = (1, 8)          # one camera; a rig's eight frames
DETECT_SEED = 3
TRACK_FRAMES = 300
TRACK_LANES = 40
DETECT_TOL = dict(atol=2e-3, rtol=1e-3)   # tests/test_nn_darknet.py:159


def yolov4_tiny_cfg():
    """yolov4-tiny's architecture (``tests/darknet_cfgs.py``), parsed."""
    import tempfile

    from sara_tpu_torch.nn import parse_darknet_cfg

    with tempfile.TemporaryDirectory() as tmp:
        return parse_darknet_cfg(load_helper("darknet_cfgs").write_cfg(tmp))


def conv_flops(params, outputs) -> float:
    """Floating-point operations of a forward's convolutions, counted from
    the run's own output shapes: 2 x (in channels / groups) x k x k per
    output element."""
    return float(sum(2.0 * o.numel() * p["w"][0].numel()
                     for p, o in zip(params, outputs) if p is not None))


def decode_image(yolo_outs, b: int, hw: int) -> dict:
    """Image ``b``'s decoded boxes from every YOLO head, concatenated."""
    from sara_tpu_torch.nn import yolo_decode

    dec = [yolo_decode(f[b:b + 1], sec, hw, hw) for _, f, sec in yolo_outs]
    return {k: torch.cat([d[k] for d in dec]) for k in dec[0]}


def nms_of(dec: dict, max_out: int = 64):
    """``nms_boxes`` over decoded boxes, on their device: (idx, keep)."""
    from sara_tpu_torch.nn import nms_boxes

    return nms_boxes(dec["boxes"], dec["score"], dec["mask"],
                     max_out=max_out)


def track_stream(n_frames: int = TRACK_FRAMES, lanes: int = TRACK_LANES,
                 seed: int = 0):
    """Seeded detections of up to ``lanes`` boxes per frame at constant
    velocity, 1 px of noise on (cx, cy, w, h), 10% dropped, in a shuffled
    order, in a 1920-px-wide view. Each object keeps to its own horizontal
    lane, 80 px apart, and is 40-56 px tall and 56-88 px wide, so two
    boxes are always >= 24 px (24 sigma of the noise) apart and never
    overlap. Objects enter and leave: each
    lane holds a sequence of objects living 60-200 frames, the first
    appearing at frame 0-20 and each next one 10-30 frames after the last
    has gone (longer than ``max_misses``, so a lane's old track has died
    before the next object arrives). Returns (frames: (boxes (n, 4)
    float32, object ids (n,)), objects: dicts of id, start, end, truth
    (frame -> (cx, cy)))."""
    rs = np.random.RandomState(seed)
    objects = []
    for lane in range(lanes):
        t = int(rs.randint(0, 21))
        while t < n_frames:
            life = int(rs.randint(60, 201))
            objects.append(dict(
                id=len(objects), start=t, end=min(t + life, n_frames),
                p0=np.array([rs.uniform(60.0, 1400.0), 40.0 + 80.0 * lane]),
                v=np.array([rs.uniform(0.5, 2.0), rs.uniform(-0.05, 0.05)]),
                size=np.array([rs.uniform(56.0, 88.0),
                               rs.uniform(40.0, 56.0)])))
            t += life + int(rs.randint(10, 31))
    frames = []
    for k in range(n_frames):
        live = [o for o in objects if o["start"] <= k < o["end"]]
        boxes, ids = [], []
        for o in live:
            if rs.rand() < 0.1:
                continue
            c = o["p0"] + o["v"] * (k - o["start"])
            boxes.append(np.concatenate([c, o["size"]])
                         + rs.normal(scale=1.0, size=4))
            ids.append(o["id"])
        order = rs.permutation(len(ids))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4)[order],
                       np.asarray(ids, np.int64)[order]))
    for o in objects:
        o["truth"] = {k: o["p0"] + o["v"] * (k - o["start"])
                      for k in range(o["start"], o["end"])}
    return frames, objects


def run_tracker(device, frames):
    """``frames``' boxes through a fresh ``MultiObjectTracker`` on
    ``device``: (per-frame outputs, ms per step, the tracker)."""
    from sara_tpu_torch.tracking import MultiObjectTracker

    dev = torch.device(device)
    mot = MultiObjectTracker(device=dev)
    outs = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for boxes in frames:
        outs.append(mot.step(boxes))
    return outs, (time.perf_counter() - t0) * 1e3 / max(len(frames), 1), mot


def same_tracks(a, b, tol: float = 1e-3) -> tuple:
    """Whether two runs' per-frame outputs have the same IDs in the same
    order, and the largest box difference (px)."""
    worst = 0.0
    for fa, fb in zip(a, b):
        if [i for i, _ in fa] != [i for i, _ in fb]:
            return False, float("inf")
        for (_, x), (_, y) in zip(fa, fb):
            worst = max(worst, float(np.abs(x - y).max()))
    return len(a) == len(b) and worst <= tol, worst


def identity_check(outs, objects, radius: float = 20.0) -> dict:
    """Each confirmed output mapped to the object present in its frame
    whose true centre is nearest (within ``radius`` px): the objects that
    were confirmed, and the tracks and objects seen under more than one
    identity."""
    by_frame = {}
    for o in objects:
        for k, c in o["truth"].items():
            by_frame.setdefault(k, []).append((o["id"], c))
    tid_obj, obj_tid = {}, {}
    for k, out in enumerate(outs):
        live = by_frame.get(k, [])
        if not live:
            continue
        centres = np.stack([c for _, c in live])
        for tid, box in out:
            d = np.linalg.norm(centres - box[:2], axis=1)
            if d.min() <= radius:
                oid = live[int(d.argmin())][0]
                tid_obj.setdefault(tid, set()).add(oid)
                obj_tid.setdefault(oid, set()).add(tid)
    return {"confirmed": set(obj_tid),
            "tracks_on_many_objects": sorted(
                t for t, s in tid_obj.items() if len(s) > 1),
            "objects_under_many_tracks": sorted(
                o for o, s in obj_tid.items() if len(s) > 1)}


def phase_detect_track(ps, card: str, device="cuda", hw: int = DETECT_HW,
                       batches=DETECT_BATCHES, n_frames: int = TRACK_FRAMES,
                       lanes: int = TRACK_LANES, whole_frames: int = 30
                       ) -> dict:
    """Slice F's detect-and-track path at full width: yolov4-tiny
    (``tests/darknet_cfgs.py``, the published architecture, random weights
    from seed 3, batch-norm statistics and biases drawn off the identity
    by ``perturb_batch_norm``) at 416x416x3 float32 on batches of 1 and 8 seeded
    textures through ``darknet_forward``, ``yolo_decode`` per head and
    ``nms_boxes`` (64 slots); a seeded 300-frame stream of up to 40 boxes
    through ``MultiObjectTracker.step``; and 30 frames of the detector's
    own NMS output through the tracker. Gates: the heads are (13, 13, 255)
    and (26, 26, 255); the card's heads equal the port's CPU run on the
    same inputs within atol 2e-3, rtol 1e-3; NMS picks the CPU's indices
    from the same decoded boxes; every object present for >= min_hits + 2
    frames is confirmed, with no identity switch; the card's track IDs
    equal the CPU's, boxes within 1e-3 px; the whole path's output is
    finite, with the CPU's IDs; K1 and K2 launch no time. Records forward
    ms at each batch (CUDA events, median of 20), the convolutions' FLOPs
    and TFLOP/s, decode + NMS ms, tracker ms and syncs per step, a profile
    of one batch-1 forward and peak memory."""
    from sara_tpu_torch.nn import darknet_forward, init_darknet_params

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = yolov4_tiny_cfg()
    host, _ = init_darknet_params(cfg, seed=DETECT_SEED, device="cpu")
    host = load_helper("darknet_cfgs").perturb_batch_norm(host, DETECT_SEED)
    cpu_params = [None if p is None else
                  {k: torch.as_tensor(v) for k, v in p.items()} for p in host]
    params = [None if p is None else {k: v.to(dev) for k, v in p.items()}
              for p in cpu_params]
    out = {"hw": hw, "batches": list(batches), "seed": DETECT_SEED}
    gates = []                  # (passed, message), checked after the log
    ps.reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    for b in batches:
        x = np.stack([texture(100 + i, hw, hw) for i in range(b)])
        x = np.repeat(x[..., None], 3, axis=-1)      # (b, hw, hw, 3)
        xd = torch.from_numpy(x).to(dev)
        yolo, outs = darknet_forward(params, cfg, xd)
        cyolo, _ = darknet_forward(cpu_params, cfg, torch.from_numpy(x))
        shapes = sorted(tuple(f.shape[1:]) for _, f, _ in yolo)
        gates.append((shapes == [(hw // 32, hw // 32, 255),
                                 (hw // 16, hw // 16, 255)],
                      f"detect: head shapes {shapes}"))
        err = 0.0
        for (_, f, _), (_, g, _) in zip(yolo, cyolo):
            a, c = f.cpu().numpy(), g.numpy()
            gates.append((np.allclose(a, c, **DETECT_TOL),
                          f"detect: batch {b} heads card vs CPU, max abs "
                          f"{np.abs(a - c).max()}"))
            err = max(err, float(np.abs(a - c).max()))
        flops = conv_flops(params, outs)
        row = {"head_err_vs_cpu": err, "gflop": flops / 1e9}
        if on_card:
            ms = timed_ms(lambda: darknet_forward(params, cfg, xd), reps=20)
            row.update(forward_ms=ms, tflop_s=flops / ms / 1e9,
                       share_of_f32_peak=flops / ms * 1e3
                       / H100_F32_FLOP_PER_S,
                       bound_ms=flops / H100_F32_FLOP_PER_S * 1e3)
        # NMS of every image against the CPU's on the same decoded boxes.
        kept = []
        for i in range(b):
            dec = decode_image(yolo, i, hw)
            idx, keep = nms_of(dec)
            cidx, ckeep = nms_of({k: v.cpu() for k, v in dec.items()})
            gates.append((torch.equal(keep.cpu(), ckeep)
                          and torch.equal(idx.cpu()[ckeep], cidx[ckeep]),
                          f"detect: NMS of image {i} (batch {b}) differs "
                          "from the CPU's"))
            kept.append(int(keep.sum()))
        row["kept_per_image"] = kept
        if on_card and b == batches[0]:
            row["decode_nms_ms"] = timed_ms(
                lambda: nms_of(decode_image(yolo, 0, hw)), reps=20)
        out[f"batch{b}"] = row
    if on_card:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # The tracking stream, on the card and on the CPU.
    frames, objects = track_stream(n_frames, lanes)
    boxes = [f[0] for f in frames]
    run_tracker(dev, boxes[:10])           # warm-up (lazy imports)
    touts, ms, mot = run_tracker(dev, boxes)
    couts, cms, _ = run_tracker("cpu", boxes)
    ok, worst = same_tracks(touts, couts)
    ident = identity_check(touts, objects)
    long_lived = {o["id"] for o in objects
                  if o["end"] - o["start"] >= mot.min_hits + 2}
    out["tracking"] = {
        "frames": n_frames, "objects": len(objects),
        "max_boxes_per_frame": max(len(b) for b in boxes),
        "ms_per_step": ms, "cpu_ms_per_step": cms,
        "device_reads_per_step": mot.syncs / n_frames,
        "card_vs_cpu_px": worst,
        "confirmed": len(ident["confirmed"] & long_lived),
        "long_lived": len(long_lived),
        "tracks_on_many_objects": ident["tracks_on_many_objects"],
        "objects_under_many_tracks": ident["objects_under_many_tracks"]}
    if on_card:
        probe = run_tracker(dev, boxes[:100])[2]
        out["tracking"]["syncs_per_step"] = count_syncs(
            lambda: probe.step(boxes[100]))
    gates += [(long_lived <= ident["confirmed"],
               f"track: objects never confirmed: "
               f"{sorted(long_lived - ident['confirmed'])}"),
              (not ident["tracks_on_many_objects"]
               and not ident["objects_under_many_tracks"],
               "track: identity switches"),
              (ok, f"track: card vs CPU IDs or boxes differ ({worst} px)")]

    # The whole path: 30 frames of a texture panning 4 px per frame.
    pan = texture(7, hw, hw + 4 * whole_frames)
    seq = np.stack([pan[:, 4 * k: 4 * k + hw] for k in range(whole_frames)])
    seq = np.repeat(seq[..., None], 3, axis=-1)
    dets = []
    for s in range(0, whole_frames, batches[-1]):
        xb = torch.from_numpy(seq[s: s + batches[-1]]).to(dev)
        yolo, _ = darknet_forward(params, cfg, xb)
        for i in range(xb.shape[0]):
            dec = decode_image(yolo, i, hw)
            idx, keep = nms_of(dec)
            dets.append(dec["boxes"][idx[keep].long()].cpu().numpy())
    wout, _, _ = run_tracker(dev, dets)
    wcpu, _, _ = run_tracker("cpu", dets)
    wok, wworst = same_tracks(wout, wcpu)
    finite = all(np.isfinite(b).all() for b in dets) and all(
        np.isfinite(x).all() for f in wout for _, x in f)
    out["whole_path"] = {"frames": whole_frames,
                         "detections_per_frame": float(np.mean(
                             [len(d) for d in dets])),
                         "confirmed_last_frame": len(wout[-1]),
                         "card_vs_cpu_px": wworst}
    counts = ps.counts()
    out["sampler_counts"] = counts
    gates += [(finite, "detect+track: non-finite output"),
              (wok, f"detect+track: card vs CPU track IDs differ "
               f"({wworst} px)"),
              (sum(counts.values()) == 0, f"detect_track launched {counts}")]
    log("detect_track", json.dumps(out), f"({card})")
    for passed, msg in gates:
        check(passed, msg)
    if on_card:
        x1 = torch.from_numpy(np.repeat(texture(100, hw, hw)[None, ..., None],
                                        3, axis=-1)).to(dev)
        profile_frame(lambda: darknet_forward(params, cfg, x1),
                      out["batch1"]["forward_ms"], top=10,
                      what="yolov4-tiny forward (batch 1)")
    return out


def kp_overlap(a, sa, b, sb, tol: float = 0.5,
               scale_tol: float = 0.01) -> float:
    """Share of the keypoints (positions ``a`` (N, 2), scales ``sa``) with
    a keypoint of ``b`` within ``tol`` px at a scale within ``scale_tol``
    relative (a Harris corner has a keypoint at each scale of one
    position). Host arrays or CPU tensors."""
    a, sa, b, sb = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
                    for v in (a, sa, b, sb))
    if len(a) == 0:
        return 1.0
    near = torch.cdist(a, b) <= tol
    same = torch.log(sa[:, None] / sb[None]).abs() <= scale_tol
    return float((near & same).any(1).double().mean())


def phase_propagation(ps, card: str, frames, device="cuda") -> dict:
    """Slice F's feature and matching extras (E2) on the frame pair of
    the main path, with no new frontend run: ``propagate_matches`` (32
    seeds) at the pair's full match capacity on the keypoints and matches
    that ``phase_main_path`` computed; ``compute_log_keypoints``,
    ``compute_doh_keypoints`` and ``compute_harris_laplace_keypoints`` on
    frame A at 480x640; ``adapt_affine_shapes`` on the Harris-Laplace
    keypoints; ``dense_sift`` at step 8; ``ncc_match`` between the pair's
    keypoints; ``self_match`` on frame A's. Gates (after the log line):
    every densified match agrees with the 16-px shift within 1 px; NCC
    recovers the shift for at least half of frame A's matched keypoints;
    each detector finds keypoints; every output equals the port's CPU run
    on the same inputs (keypoint sets by overlap, nearest within 0.5 px at
    a scale within 1%, for >= 98% of either set; shapes and descriptors
    within 1e-4; propagation's members and labels equal; NCC's accepted
    matches equal as pairs of patch centres, scores within 1e-5;
    self-matching's accepted matches equal); K1 and K2 launch no time.
    Records ms per call (CUDA events) and the sweeps' device time (the
    largest GEMM of a profile of ``propagate_matches``)."""
    from sara_tpu_torch.core.types import Keypoints, Matches
    from sara_tpu_torch.features.affine import adapt_affine_shapes
    from sara_tpu_torch.features.dense import dense_sift
    from sara_tpu_torch.features import multiscale as ms
    from sara_tpu_torch.matching import propagation as prop
    from sara_tpu_torch.matching.key_proximity import self_match
    from sara_tpu_torch.matching.ncc import ncc_match

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ka, kb, m = frames
    cpu = lambda c, t: t(*(f.cpu() for f in c))
    cka, ckb, cm = cpu(ka, Keypoints), cpu(kb, Keypoints), cpu(m, Matches)
    h, w = FRAME_HW
    tex = texture(1, h, w + SHIFT_PX)
    frame_a, frame_b = tex[:, SHIFT_PX:], tex[:, :w]
    out = {"match_capacity": m.capacity, "matches": int(m.count())}
    gates = []                  # (passed, message), checked after the log
    ps.reset_counts()

    def timed(name, fn):
        res, ms_ = events_ms(fn, dev)
        out[f"{name}_ms"] = ms_
        return res

    def differ(a, b) -> int:
        return int((a.cpu() != b).sum())

    # Match propagation at the pair's capacity.
    params = prop.PropagationParams()
    members, labels, dens = timed("propagate_first",
                                  lambda: prop.propagate_matches(ka, kb, m,
                                                                 32))
    cmem, clab, cdens = prop.propagate_matches(cka, ckb, cm, 32)
    i, j = m.i[dens].long(), m.j[dens].long()
    d = kb.xy[j] - ka.xy[i]
    off = float(torch.maximum((d[:, 0] - SHIFT_PX).abs(), d[:, 1].abs())
                .max()) if len(i) else 0.0
    C = prop.match_consistency_matrix(ka, kb, m, params)
    cC = prop.match_consistency_matrix(cka, ckb, cm, params)
    scores = torch.sort(m.score[m.mask]).values
    out.update(densified=int(dens.sum()),
               regions=int((members.sum(1) > 0).sum()),
               densified_off_shift_px=off,
               consistency_pairs=int(C.sum()),
               consistency_differ_vs_cpu=differ(C, cC),
               tied_seed_scores=int((scores == scores[31]).sum()),
               members_differ_vs_cpu=differ(members, cmem),
               labels_differ_vs_cpu=differ(labels, clab),
               densified_differ_vs_cpu=differ(dens, cdens))
    gates += [(int(dens.sum()) > 0, "propagation: nothing densified"),
              (off <= 1.0, f"propagation: a densified match {off} px off "
               "the shift"),
              (out["members_differ_vs_cpu"] == 0
               and out["labels_differ_vs_cpu"] == 0,
               "propagation: card vs CPU members / labels differ")]
    if on_card:
        out["consistency_ms"] = timed_ms(
            lambda: prop.match_consistency_matrix(ka, kb, m, params), reps=5)
        out["sweep_gflop"] = (2.0 * 32 * m.capacity ** 2 * params.num_iters
                              / 1e9)
        out["propagate_ms"] = timed_ms(
            lambda: prop.propagate_matches(ka, kb, m, 32), reps=5)
    del C, cC

    # The scale-space detectors on frame A, and the card against the CPU.
    for name in ("log", "doh", "harris_laplace"):
        fn = getattr(ms, f"compute_{name}_keypoints")
        k = timed(f"{name}_first", lambda: fn(frame_a, device=dev))
        ck = fn(frame_a, device="cpu")
        pa = (k.xy.cpu()[k.mask.cpu()], k.scale.cpu()[k.mask.cpu()])
        pb = (ck.xy[ck.mask], ck.scale[ck.mask])
        share = min(kp_overlap(*pa, *pb), kp_overlap(*pb, *pa))
        out[f"{name}_keypoints"] = int(k.count())
        out[f"{name}_overlap_vs_cpu"] = share
        gates += [(int(k.count()) > 0, f"{name}: no keypoints"),
                  (share >= 0.98, f"{name}: card vs CPU overlap {share}")]
        if on_card:
            out[f"{name}_ms"] = timed_call_ms(lambda: fn(frame_a, device=dev),
                                              dev)
    kh = k                                  # the Harris-Laplace keypoints

    # Affine shapes on the card's Harris-Laplace keypoints.
    args = (kh.xy, kh.scale, kh.mask)
    S, conv = timed("affine", lambda: adapt_affine_shapes(frame_a, *args,
                                                          device=dev))
    cS, cconv = adapt_affine_shapes(frame_a, *(a.cpu() for a in args),
                                    device="cpu")
    valid = kh.mask.cpu()
    serr = float((S.cpu() - cS)[valid].abs().max())
    out.update(affine_err_vs_cpu=serr, affine_converged=int(conv.sum()),
               affine_converged_differ_vs_cpu=differ(conv, cconv))
    gates += [(bool(torch.isfinite(S[kh.mask]).all()) and serr <= 1e-4,
               f"affine: card vs CPU {serr}"),
              (out["affine_converged_differ_vs_cpu"] == 0,
               "affine: convergence flags differ")]

    # Dense SIFT at step 8.
    xy, desc = timed("dense_sift", lambda: dense_sift(frame_a, step=8,
                                                      device=dev))
    cxy, cdesc = dense_sift(frame_a, step=8, device="cpu")
    derr = float((desc.cpu() - cdesc).abs().max())
    out.update(dense_descriptors=int(desc.shape[0]), dense_err_vs_cpu=derr)
    gates.append((torch.equal(xy.cpu(), cxy) and derr <= 1e-4,
                  f"dense_sift: card vs CPU {derr}"))

    # NCC between the pair's keypoints.
    nj, ns, nok = timed("ncc", lambda: ncc_match(frame_a, ka.xy, ka.mask,
                                                 frame_b, kb.xy, kb.mask,
                                                 device=dev))
    cj, cs, cok = ncc_match(frame_a, cka.xy, cka.mask, frame_b, ckb.xy,
                            ckb.mask, device="cpu")
    matched = m.i[m.mask].long()
    d = kb.xy[nj[matched].long()] - ka.xy[matched]
    on = (nok[matched] & ((d[:, 0] - SHIFT_PX).abs() <= 1)
          & (d[:, 1].abs() <= 1))
    share = float(on.float().mean()) if len(matched) else 0.0
    # A keypoint detected with several orientations is one patch repeated:
    # its correlations tie up to the GEMM's last bit, which the card and
    # the CPU round differently. So matches are compared as the pairs of
    # patch centres they join (the twin's rounded positions).
    def centre_pairs(kpa, kpb, j, ok):
        ra, rb = torch.round(kpa.xy.cpu()), torch.round(kpb.xy.cpu())
        ok = ok.cpu()
        pairs = torch.cat([ra[ok], rb[j.cpu().long()[ok]]], 1)
        return {tuple(p) for p in pairs.int().tolist()}

    card_pairs = centre_pairs(ka, kb, nj, nok)
    cpu_pairs = centre_pairs(cka, ckb, cj, cok)
    both = nok.cpu() & cok
    out.update(ncc_accepted=int(nok.sum()), ncc_shift_share=share,
               ncc_centre_pairs=len(card_pairs),
               ncc_pairs_differ_vs_cpu=len(card_pairs ^ cpu_pairs),
               ncc_slots_differ_vs_cpu=differ(nok, cok),
               ncc_score_err_vs_cpu=float((ns.cpu() - cs)[both].abs().max()))
    gates += [(share >= 0.5, f"ncc: the shift for only {share} of the "
               "matched keypoints"),
              (out["ncc_pairs_differ_vs_cpu"] == 0
               and out["ncc_score_err_vs_cpu"] <= 1e-5,
               "ncc: card vs CPU matches differ")]

    # Self-matching on frame A.
    sm = timed("self_match", lambda: self_match(ka))
    csm = self_match(cka)
    both = sm.mask.cpu() & csm.mask
    out.update(self_matches=int(sm.count()),
               self_match_ok_differ_vs_cpu=differ(sm.mask, csm.mask),
               self_match_j_differ_vs_cpu=int(
                   (sm.j.cpu() != csm.j)[both].sum()))
    gates.append((out["self_match_ok_differ_vs_cpu"] == 0
                  and out["self_match_j_differ_vs_cpu"] == 0,
                  "self_match: card vs CPU matches differ"))

    counts = ps.counts()
    out["sampler_counts"] = counts
    gates.append((sum(counts.values()) == 0,
                  f"propagation launched {counts}"))
    if on_card:
        # The sweeps' device time: the profile's largest GEMM (its calls
        # are the sweeps, ``params.num_iters`` of them).
        prof = profile_frame(lambda: prop.propagate_matches(ka, kb, m, 32),
                             out["propagate_ms"], top=8,
                             what="propagate_matches (M = 8192)")
        gemms = [e for e in (prof or {"top": []})["top"]
                 if "gemm" in e["name"].lower()]
        out["sweep_gemm"] = gemms[0] if gemms else "not measured"
    log("propagation", json.dumps(out), f"({card})")
    for passed, msg in gates:
        check(passed, msg)
    return out


E3_SIGMA = 2.0                   # deriche_blur
E3_SLIC = dict(grid=16, iters=10)
E3_CONV = 7                      # gemm_conv2d's kernel side
E3_DISC = 100.0                  # signed_distance's disc radius, px
E3_MARKER_STEP = 48              # watershed markers: one per 48 x 48 cell
E3_FLOW = dict(steps=50, dt=0.1, band=6.0)   # NarrowBand curvature flow


def e3_inputs(hw=FRAME_HW, seed: int = 9) -> dict:
    """Phase "e3"'s inputs: frame A of the frame pair, a seeded 7x7 kernel,
    watershed markers on a grid, and a disc's mask and signed distance
    centred in the frame."""
    h, w = hw
    frame = texture(1, h, w + SHIFT_PX)[:, SHIFT_PX:].copy()
    rs = np.random.RandomState(seed)
    kernel = rs.normal(size=(E3_CONV, E3_CONV)).astype(np.float32)
    markers = np.zeros((h, w), np.int32)
    ys = np.arange(E3_MARKER_STEP // 2, h, E3_MARKER_STEP)
    xs = np.arange(E3_MARKER_STEP // 2, w, E3_MARKER_STEP)
    markers[np.ix_(ys, xs)] = np.arange(1, len(ys) * len(xs) + 1).reshape(
        len(ys), len(xs))
    yy, xx = np.mgrid[0:h, 0:w]
    radius = min(E3_DISC, 0.4 * min(h, w))
    dist = np.hypot(xx - w / 2, yy - h / 2)
    return dict(frame=frame, kernel=kernel, markers=markers,
                disc=dist < radius,
                phi=(dist - radius).astype(np.float32))


def curvature_flow(phi, device):
    """E3_FLOW's band-gated curvature flow of ``phi`` on ``device``: the
    NarrowBand after its steps (phi, reinitialisations, device reads)."""
    from sara_tpu_torch.image import levelsets as lv

    nb = lv.NarrowBand(phi, band_radius=E3_FLOW["band"], device=device)
    nb.run(lv.curvature_motion, E3_FLOW["dt"], E3_FLOW["steps"])
    return nb


def phase_e3(ps, card: str, device="cuda", hw=FRAME_HW) -> dict:
    """Slice E3 (the last image modules) at the frame size users feed the
    frontend, on frame A of the frame pair: ``deriche_blur`` (sigma 2),
    ``otsu_threshold``, ``adaptive_threshold``, ``label_connected_components``
    on the Otsu mask, ``watershed`` from a grid of markers, ``slic`` (grid
    16, 10 iterations), ``gemm_conv2d`` with a 7x7 kernel, ``signed_distance``
    of a disc of radius 100, a 50-step ``NarrowBand`` curvature flow and
    ``suzuki_abe_borders`` on the card's CCL mask. Each result is held to
    the port's CPU run on the same inputs (a stage fed by an earlier one
    takes the card's output there too): the labels of CCL and watershed and
    the contours equal; SLIC's labels equal for >= 99.9% of the pixels
    (``index_add_``'s float atomics sum the centres in another order),
    centres within 1e-3 px; Deriche and ``gemm_conv2d`` within 1e-5
    relative; the distances and the flow within 1e-4, the flow with the
    same reinitialisations; Otsu's threshold within 1e-6 and its mask
    equal; the sampler launches no time. Records for each function ms
    (median of 5 after a synchronize), device operations (launches, copies,
    memsets) and busy / idle from one profile, and host syncs."""
    from sara_tpu_torch.core.contours import suzuki_abe_borders
    from sara_tpu_torch.image import levelsets as lv
    from sara_tpu_torch.image import segmentation as sg
    from sara_tpu_torch.image.deriche import deriche_blur
    from sara_tpu_torch.image.im2col import gemm_conv2d
    from sara_tpu_torch.image.slic import slic

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    inp = e3_inputs(hw)
    dv = {k: torch.as_tensor(v).to(dev) for k, v in inp.items()}
    ch = {k: torch.as_tensor(v) for k, v in inp.items()}
    rows, gates = {}, []

    def measure(name, fn, profile=True):
        """``fn``'s result on ``dev``; its ms (median of 5 more calls, each
        after a synchronize), device operations and busy / idle from one
        profile (unless ``profile`` is False), and host syncs."""
        res = fn()
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"ms": float(np.median(times))}
        if on_card:
            prof = profile and profile_frame(fn, row["ms"], top=5,
                                             what=f"e3 {name}")
            row.update({k: prof[k] for k in ("device_ops", "device_busy_ms",
                                            "idle_share", "profiling_s")}
                       if prof else {"device_ops": "not measured" + (
                           "" if profile else " (profile cut)")})
            row["syncs"] = count_syncs(fn)["syncs"]
        rows[name] = row
        return res

    def rel(a, b) -> float:
        a, b = a.cpu().double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    ps.reset_counts()
    blur = measure("deriche_blur", lambda: deriche_blur(dv["frame"],
                                                        E3_SIGMA))
    err = rel(blur, deriche_blur(ch["frame"], E3_SIGMA))
    gates.append((err <= 1e-5, f"deriche_blur: card vs CPU {err}"))
    rows["deriche_blur"]["rel_err_vs_cpu"] = err

    thr, mask = measure("otsu_threshold",
                        lambda: sg.otsu_threshold(dv["frame"]))
    cthr, cmask = sg.otsu_threshold(ch["frame"])
    rows["otsu_threshold"].update(threshold=float(thr),
                                  threshold_cpu=float(cthr),
                                  foreground=int(mask.sum()))
    gates.append((abs(float(thr) - float(cthr)) <= 1e-6
                  and torch.equal(mask.cpu(), cmask),
                  f"otsu: card {float(thr)} vs CPU {float(cthr)}"))

    amask = measure("adaptive_threshold",
                    lambda: sg.adaptive_threshold(dv["frame"]))
    differ = int((amask.cpu() != sg.adaptive_threshold(ch["frame"])).sum())
    rows["adaptive_threshold"]["differ_vs_cpu"] = differ
    gates.append((differ == 0, f"adaptive_threshold: {differ} pixels differ"))

    lab = measure("label_connected_components",
                  lambda: sg.label_connected_components(mask))
    clab = sg.label_connected_components(mask.cpu())
    n_comp = int(torch.unique(clab).numel()) - 1
    rows["label_connected_components"].update(
        components=n_comp, differ_vs_cpu=int((lab.cpu() != clab).sum()))
    gates.append((torch.equal(lab.cpu(), clab) and n_comp > 0,
                  "label_connected_components: card vs CPU labels differ"))

    ws = measure("watershed", lambda: sg.watershed(dv["frame"],
                                                   dv["markers"]))
    cws = sg.watershed(ch["frame"], ch["markers"])
    rows["watershed"].update(unlabelled=int((cws == 0).sum()),
                             differ_vs_cpu=int((ws.cpu() != cws).sum()))
    gates.append((torch.equal(ws.cpu(), cws),
                  "watershed: card vs CPU labels differ"))

    slab, cen = measure("slic", lambda: slic(dv["frame"], **E3_SLIC))
    cslab, ccen = slic(ch["frame"], **E3_SLIC)
    same = float((slab.cpu() == cslab).double().mean())
    cerr = float((cen.cpu() - ccen)[..., :2].abs().max())
    rows["slic"].update(label_agreement=same, centre_err_px=cerr,
                        superpixels=int(cen.shape[0] * cen.shape[1]))
    gates.append((same >= 0.999 and cerr <= 1e-3,
                  f"slic: {same} of labels equal, centres {cerr} px"))

    conv = measure("gemm_conv2d", lambda: gemm_conv2d(dv["frame"],
                                                      dv["kernel"]))
    err = rel(conv, gemm_conv2d(ch["frame"], ch["kernel"]))
    rows["gemm_conv2d"]["rel_err_vs_cpu"] = err
    gates.append((err <= 1e-5, f"gemm_conv2d: card vs CPU {err}"))

    sd = measure("signed_distance", lambda: lv.signed_distance(dv["disc"]))
    csd = lv.signed_distance(ch["disc"])
    err = float((sd.cpu() - csd).abs().max())
    rows["signed_distance"].update(err_vs_cpu=err, row_steps=4 * 4 * hw[0])
    gates.append((err <= 1e-4, f"signed_distance: card vs CPU {err}"))

    # Cut to keep the script inside its time: this second profile of
    # ~120,000 launches took 12-22 s on the card; the flow's ms and syncs
    # stay, and signed_distance's profile shows the same row loops.
    log("e3: narrow_band_flow's profile cut (~120,000 launches, 12-22 s); "
        "its ms and syncs are measured")
    nb = measure("narrow_band_flow", lambda: curvature_flow(dv["phi"], dev),
                 profile=False)
    cnb = curvature_flow(ch["phi"], cpu)
    err = float((nb.phi.cpu() - cnb.phi).abs().max())
    rows["narrow_band_flow"].update(err_vs_cpu=err, reinits=nb.reinits,
                                    reinits_cpu=cnb.reinits,
                                    band_reads=nb.syncs)
    gates.append((err <= 1e-4 and nb.reinits == cnb.reinits,
                  f"narrow band: card vs CPU {err}, reinits {nb.reinits} "
                  f"vs {cnb.reinits}"))

    fg = lab > 0
    borders = measure("suzuki_abe_borders", lambda: suzuki_abe_borders(fg))
    cborders = suzuki_abe_borders(clab > 0)
    same = sorted(borders) == sorted(cborders) and all(
        (b.parent, int(b.type)) == (cborders[k].parent, int(cborders[k].type))
        and np.array_equal(np.asarray(b.curve), np.asarray(cborders[k].curve))
        for k, b in borders.items())
    rows["suzuki_abe_borders"].update(borders=len(borders))
    gates.append((same, "suzuki_abe_borders: card vs CPU borders differ"))

    counts = ps.counts()
    out = {"hw": list(hw), "functions": rows, "sampler_counts": counts}
    gates.append((sum(counts.values()) == 0, f"e3 launched {counts}"))
    log("e3", json.dumps(out), f"({card})")
    for passed, msg in gates:
        check(passed, msg)
    return out


# The six demo twins, by name: (file in examples/, the arguments phase
# "demos" gives it beside --out and --cpu).
DEMOS = {
    "two_view": ("torch_two_view_demo", []),
    "homography": ("torch_homography_estimation_demo", []),
    "essential_5_point": ("torch_essential_5_point_demo", []),
    "two_view_ba": ("torch_two_view_ba_demo", []),
    "visual_odometry": ("torch_visual_odometry_demo", ["--synthetic"]),
    "global_sfm": ("torch_global_sfm_demo", []),
}
DEMO_VO_FRAMES = 20
DEMO_SFM_VIEWS = 8


def load_demo(name: str):
    """The module of a demo twin in ``examples/``, by path."""
    import importlib.util
    from pathlib import Path

    file = DEMOS[name][0]
    path = Path(__file__).resolve().parent / "examples" / f"{file}.py"
    spec = importlib.util.spec_from_file_location(file, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demo_failures(name: str, out: dict, width: int = 640,
                  views: int = DEMO_SFM_VIEWS) -> list:
    """The gates a demo twin's result must pass, against the synthetic
    truth of its default input; returns the messages of those it fails.
    ``width`` is the synthetic frame's, ``views`` the SfM demo's."""
    bad = []

    def need(ok, msg):
        if not ok:
            bad.append(f"{name}: {msg}")

    if name == "two_view":
        m, res = out["matches"], out["ransac"]
        i, j = m.i[m.mask].long(), m.j[m.mask].long()
        d = out["kb"].xy[j] - out["ka"].xy[i]
        on = ((d[:, 0] - SHIFT_PX).abs() <= 1) & (d[:, 1].abs() <= 1)
        share = float(on.float().mean()) if len(i) else 0.0
        n, inl = int(m.count()), int(res.num_inliers)
        out.update(on_shift=share, inlier_share=inl / max(n, 1))
        need(n >= 50 and share >= 0.9, f"{n} matches, {share} on the shift")
        need(bool(res.success) and inl >= 0.9 * n, f"{inl} of {n} inliers")
    elif name == "homography":
        n, inl = int(out["matches"].count()), int(out["ransac"].num_inliers)
        err = float(out["corner_err"].max())
        need(bool(out["ransac"].success) and inl >= 0.8 * n,
             f"{inl} of {n} inliers")
        need(err <= 0.02 * width, f"corner transfer error {err} px")
    elif name == "essential_5_point":
        n, inl = out["matches"], out["inliers"]
        # The synthetic view is a plane's homography, so two motions explain
        # it equally: the rotation is gated, the translation direction only
        # logged.
        need(out["success"] and inl >= 0.8 * n, f"{inl} of {n} inliers")
        need(out["rotation_err_deg"] <= 2.0,
             f"rotation error {out['rotation_err_deg']} deg")
        need(out["sampson_median"] <= 1e-3,
             f"median Sampson residual {out['sampson_median']}")
        need(out["cheiral"] >= 0.5 * inl, f"{out['cheiral']} cheiral points")
    elif name == "two_view_ba":
        need(out["success"], "relative pose failed")
        need(out.get("points", 0) >= 30, f"{out.get('points')} points")
        need(out.get("rms1", 1e9) <= min(out.get("rms0", 0.0) + 1e-6, 0.5),
             f"RMS {out.get('rms0')} -> {out.get('rms1')} px")
    elif name == "visual_odometry":
        added = [ok for _, ok, _ in out["frames"]]
        need(all(added), f"frames rejected: {added.count(False)}")
        need(out["ate"] <= 0.05 and out["points"] > 100,
             f"ATE {out['ate']}, {out['points']} points")
    elif name == "global_sfm":
        # The float32 BA stalls short of its optimum where summation order
        # says, in both packages (ROADMAP §3, F6): its ATE is logged, and
        # the float64 solution of the same problem is gated.
        info = out["ba_info"]
        ate64, cost64 = sfm_float64_solution(out)
        out.update(ate_float64=ate64, ba_cost_float64=cost64,
                   ba_initial_cost=float(info["initial_cost"]),
                   ba_final_cost=float(info["final_cost"]))
        need(out["edges"] >= views - 1 and out["points"] > 100,
             f"{out['edges']} edges, {out['points']} points")
        need(out["ba_final_cost"] < out["ba_initial_cost"],
             f"BA cost {out['ba_initial_cost']} -> {out['ba_final_cost']}")
        need(ate64 <= 0.05, f"float64 BA of the same problem: ATE {ate64} "
             f"(float32 {out['ate']})")
    return bad


def sfm_float64_solution(out: dict):
    """The global SfM demo's own BA problem (``out["ba_problem"]``, as
    triangulation handed it over) solved in float64 where it lies, with
    the pipeline's BA options: (ATE of its centres against
    ``out["centers"]``, its final cost). It holds every stage before the
    BA, and the BA's model, to the truth without the float32 stall."""
    from sara_tpu_torch.ba import bundle_adjust
    from sara_tpu_torch.core import lie
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig
    from sara_tpu_torch.utils import ate_rmse

    prob = out["ba_problem"]
    prob = prob._replace(**{k: getattr(prob, k).double()
                            for k in ("poses", "points", "intrinsics", "uv")})
    res, info = bundle_adjust(prob, GlobalSfMConfig().ba_options)
    poses = res.poses.cpu()
    R = lie.so3_exp(poses[:, :3])
    centers = -(R.transpose(1, 2) @ poses[:, 3:, None])[..., 0]
    return (ate_rmse(centers.numpy(), out["centers"]),
            float(info["final_cost"]))


def phase_demos(ps, card: str, device="cuda", width: int = 640,
                vo_frames: int = DEMO_VO_FRAMES,
                sfm_views: int = DEMO_SFM_VIEWS) -> dict:
    """Slice E6: the six demo twins in ``examples/`` through their
    ``main(argv)``, as a user runs them, on their default inputs (the
    synthetic pair at ``width``, 640 by default; ``vo_frames`` synthetic VO
    frames; ``sfm_views`` rendered views), each gated on its result against
    the synthetic truth (``demo_failures``). On the CPU ``--cpu`` is passed;
    on the card nothing is, so each twin takes the card itself. Records
    each demo's seconds, its printed numbers and the sampler's launches
    (0: the demos take the default gather sampler)."""
    import contextlib
    import io
    import tempfile

    extra = {"visual_odometry": ["--max-frames", str(vo_frames)],
             "global_sfm": ["--views", str(sfm_views)]}
    sized = ("two_view", "homography", "essential_5_point", "two_view_ba")
    out, bad = {}, []
    ps.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name, (_, args) in DEMOS.items():
            argv = list(args) + extra.get(name, [])
            if name in sized:
                argv += ["--width", str(width)]
            if name != "essential_5_point":
                argv += ["--out", f"{tmp}/{name}"]
            if torch.device(device).type == "cpu":
                argv.append("--cpu")
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                res = load_demo(name).main(argv)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            bad += demo_failures(name, res, width, sfm_views)
            out[name] = {"s": secs, "argv": argv,
                         "printed": printed.getvalue().strip().splitlines(),
                         **{k: v for k, v in res.items()
                            if isinstance(v, (int, float, bool, str))}}
            log(f"demo {name}: {secs:.2f} s", json.dumps(out[name]))
    out["sampler_counts"] = ps.counts()
    log("demos", json.dumps({k: out[k]["s"] for k in DEMOS}),
        f"sampler {json.dumps(out['sampler_counts'])} ({card})")
    check(not bad, "; ".join(bad))
    check(sum(out["sampler_counts"].values()) == 0,
          f"demos launched {out['sampler_counts']}")
    return out



# The runs of phase "tools": (run, twin in scripts/, argv, the cut against
# the tool's defaults). Each twin runs through its main(argv) as a user
# runs it.
TOOL_RUNS = [
    ("eval_vo", "eval_vo", ["--frames", "12"],
     "12 synthetic keypoint frames (default 60)"),
    ("eval_vo_room", "eval_vo",
     ["--room", "--loop", "--pipelined", "--frames", "40"],
     "the room loop at 240x320 over 40 frames (config 3: 100), "
     "pipelined, with closure"),
    ("bench_vo_frontend", "bench_vo_frontend", ["--frames", "8"],
     "8 frames (default 12)"),
    ("bench_ba", "bench_ba", ["--sizes", "small"],
     "size small (default small,medium; phase ba runs large)"),
    ("bench_sfm_scale", "bench_sfm_scale", ["--views", "32"],
     "32 views (default 128, phase global_sfm's)"),
    ("bench_city_scale", "bench_city_scale", ["--views", "64"],
     "64 views (default 1024; phase city runs 1024 and 256)"),
    ("bench_config5_real", "bench_config5_real", ["--views", "32"],
     "32 views (default 128); mesh table n = 1 (one card)"),
    ("eval_real_images", "eval_real_images", ["--frames", "10"],
     "nothing cut (10 frames at 480x640)"),
    ("mc_fivepoint", "mc_fivepoint", ["--n", "1000"],
     "1,000 problems (default 10,000)"),
    ("eval_detection_quality", "eval_detection_quality", [],
     "nothing cut (480x640, the tool's defaults); no OpenCV on the card's "
     "machine, so no OpenCV baseline, and the warp is warp_homography's "
     "on the card"),
]
# The twins whose runs detect SIFT on rendered pixels (K1 on the card).
TOOLS_WITH_K1 = ("eval_vo_room", "bench_vo_frontend", "bench_config5_real",
                 "eval_real_images", "eval_detection_quality")
# K1's launches in the quality run: 4 per 480x640 frame at first_octave
# -1. The tool keeps nearest-sampled descriptors (``desc_sample_nearest``),
# so the two smallest of the 6 octaves, where the reference's TPU window
# does not fit, take nearest gathers as the reference does
# (``patch_sampler.tpu_window_fits``); the frame pair samples bilinear, 6
# per frame.
QUALITY_K1_LAUNCHES = 8
# The floor of the quality run's repeatability. The same call on the CPU
# (``detection_quality("cpu")``: the kernel sampler's plain version, two
# torch threads, an 8-core Intel Xeon) gave 0.8513339991439578 (7337 / 6676
# keypoints, 5151 of 5152 matches correct); the floor leaves 0.02 below it
# for the ulps of the card's pyramid.
QUALITY_REPEATABILITY_FLOOR = 0.83


def detection_quality(device="cuda", hw=FRAME_HW, seed=1) -> dict:
    """The quality tool's twin as ``main`` runs it, without OpenCV (absent
    on the card's machine): ``run_ours`` at the tool's defaults
    (``first_octave`` -1, capacities 8192 / 4096) on a seeded texture and
    its warp by ``make_warp``'s homography, made on ``device`` by
    ``warp_homography``, scored by the twin's ``repeatability`` and
    ``match_quality``. The warp fills with zeros where the tool's
    ``cv2.warpPerspective`` reflects the image (``BORDER_REFLECT``), so
    these numbers are not the CPU test's. The warp is the bench twin's
    (``torch_bench.warp_without_cv2``)."""
    import torch_bench

    q = load_tool("eval_detection_quality")
    h, w = hw
    H = q.make_warp(h, w)
    img = torch.from_numpy(texture(seed, h, w)).to(device)
    warped = torch_bench.warp_without_cv2(img, H, device)
    res = q.score(q.run_ours(img, warped, -1, 8192, 4096, device=device),
                  H, h, w)
    return dict(res, border_fill="zeros (the tool: cv2's reflection)",
                opencv="skipped: the card's machine has no cv2")


def load_tool(name: str):
    """The module of a command-line tool's twin, ``scripts/torch_<name>.py``,
    by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tool_failures(run: str, out: dict, argv: list) -> list:
    """The gates a tool twin's result must pass (what its tool reports,
    held as the phases that run the same path hold it); returns the
    messages of those it fails."""
    bad = []

    def need(ok, msg):
        if not ok:
            bad.append(f"{run}: {msg}")

    def arg(flag, default):
        return type(default)(argv[argv.index(flag) + 1]) if flag in argv \
            else default

    if run == "eval_vo":
        n = arg("--frames", 60)
        need(out["accepted"] >= n - 1, f"{out['accepted']}/{n} accepted")
        need(out["ate_before"] <= 0.05, f"ATE {out['ate_before']}")
    elif run == "eval_vo_room":
        n = arg("--frames", 60)
        need(out["accepted"] >= n - 1, f"{out['accepted']}/{n} accepted")
        # The float32 VO on these loops ends where summation order says,
        # in both packages (ROADMAP F6): at 180x240 over 40 frames the
        # reference's tool ends at ATE 0.083-0.085 before closure, the twin
        # at 0.088-0.26 (CPU runs, the procedural room); the 100-frame
        # loop's witness spreads the reference over 0.27-1.00. Closure on
        # a loop of 40 frames raises the ATE in both (ROADMAP F3: the
        # reference 0.08 -> 0.27-0.28, the twin 0.09-0.26 -> 0.30-0.32).
        need(out["ate_before_closure"] <= 0.30,
             f"ATE {out['ate_before_closure']} before closure")
        need(out["loop_closed"], "no loop closed")
        need(math.isfinite(out["ate_after_closure"])
             and out["ate_after_closure"] <= 0.5,
             f"ATE {out['ate_after_closure']} after closure")
    elif run == "bench_vo_frontend":
        n = arg("--frames", 12)
        for mode, r in out.items():
            need(r["accepted"] >= n - 1 and r["ate"] <= 0.10,
                 f"{mode}: {r['accepted']}/{n} accepted, ATE {r['ate']}")
    elif run == "bench_ba":
        for size, r in out.items():
            if size == "mesh":
                continue
            for solver in ("dense", "cg"):
                c = r[solver]
                need(c["final_cost"] < c["initial_cost"],
                     f"{size}[{solver}] cost {c['initial_cost']} -> "
                     f"{c['final_cost']}")
            d, g = r["dense"]["final_cost"], r["cg"]["final_cost"]
            need(abs(d - g) <= 0.01 * g, f"{size}: dense {d} vs CG {g}")
    elif run == "bench_sfm_scale":
        n = arg("--views", 128)
        need(out["num_edges"] >= n - 1, f"{out['num_edges']} edges")
        need(out["ate"] <= 0.15, f"ATE {out['ate']}")
        need(out["points"] > 500, f"{out['points']} points")
        need(out["ba_info"]["final_cost"] < out["ba_info"]["initial_cost"],
             f"BA cost {out['ba_info']}")
    elif run == "bench_city_scale":
        n = arg("--views", 1024)
        need(out["edges"] >= n - 1, f"{out['edges']} edges")
        need(out["ate"] < 2.0, f"ATE {out['ate']}")
        need(out["points"] > 500, f"{out['points']} points")
        need(out["ba_info"]["final_cost"] < out["ba_info"]["initial_cost"],
             f"BA cost {out['ba_info']}")
    elif run == "bench_config5_real":
        n = arg("--views", 128)
        need(out["edges"] >= n, f"{out['edges']} of {out['pairs']} edges")
        # The reference itself ends at ATE 0.3663 on 12 views of this loop
        # and 0.2087 on 24 (its tool on the CPU, the procedural room).
        need(out["ate"] <= 0.5, f"ATE {out['ate']}")
        need(out["points"] > 500, f"{out['points']} points")
        rows = out["partitioned_ba_scaling"]
        need(len(rows) >= 1 and all(r["final_cost"] < r["initial_cost"]
                                    for r in rows),
             f"partitioned BA {rows}")
    elif run == "eval_real_images":
        # Its global SfM on these views ends where the RANSAC draw and the
        # float32 BA say, in both packages: over five generator seeds the
        # reference's tool (the procedural room, CPU) ends at ATE
        # 0.0061-0.8766, and 0.0014-0.8895 once its own BA problem is
        # solved in float64; the twin at 0.0339-0.7804 and 0.0009-0.0834.
        # So the SfM's ATEs are logged (the float64 solve too) and its
        # structure gated; the VO on the same frames is gated on its ATE.
        n = arg("--frames", 10)
        vo, gs = out["vo"], out["global_sfm"]
        need(vo["accepted"] >= n - 1 and vo["ate"] <= 0.10,
             f"VO {vo['accepted']}/{n} accepted, ATE {vo['ate']}")
        ate64, cost64 = sfm_float64_solution(out)
        out.update(ate_float64=ate64, ba_cost_float64=cost64)
        need(gs["edges"] >= n - 1 and gs["points"] > 500
             and math.isfinite(gs["ate"]) and math.isfinite(ate64),
             f"global SfM {gs['edges']} edges, {gs['points']} points, ATE "
             f"{gs['ate']} (float64 BA of the same problem {ate64})")
    elif run == "eval_detection_quality":
        need(out["matches"] > 0
             and out["correct"] >= 0.95 * out["matches"],
             f"{out['correct']} of {out['matches']} matches correct")
        need(out["repeatability"] >= QUALITY_REPEATABILITY_FLOOR,
             f"repeatability {out['repeatability']} (floor "
             f"{QUALITY_REPEATABILITY_FLOOR})")
    elif run == "mc_fivepoint":
        # tests/test_torch_geometry.py's gate: >= 99% of the oracle's
        # solutions on generic problems, >= 97% near-planar.
        r = out["recovery_by_kind"]
        need(r["generic"] >= 0.99 and r["near_planar"] >= 0.97,
             f"recovery {r}")
    return bad


def phase_tools(ps, card: str, device="cuda", runs=None) -> dict:
    """The twins of the command-line tools (``scripts/torch_*.py``) through
    their ``main(argv)`` on ``device``, at the sizes of ``TOOL_RUNS`` (each
    cut printed beside the tool's default), each gated by
    ``tool_failures``. The sampler counts are set to 0 just before each run
    and read just after: the runs that detect SIFT on rendered pixels launch
    K1's vector variant and nothing else on the card, the others nothing.
    ``eval_vo_video`` is left out and ``eval_detection_quality`` runs
    without its OpenCV baseline (``detection_quality``): the card's machine
    has no OpenCV.
    Returns each run's seconds, result and launches."""
    import contextlib
    import io
    import os
    import tempfile

    dev = torch.device(device)
    out, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for run, tool, argv, cut in runs or TOOL_RUNS:
            argv = list(argv) + ["--device", str(device)]
            if tool in ("eval_vo", "eval_real_images"):
                argv += ["--out", os.path.join(tmp, f"{run}.json")]
            elif tool in ("bench_city_scale", "bench_config5_real"):
                argv += ["--json", os.path.join(tmp, f"{run}.json")]
            ps.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = (detection_quality(dev)
                       if tool == "eval_detection_quality"
                       else load_tool(tool).main(argv))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = ps.counts()
            bad += tool_failures(run, res, argv)
            if dev.type == "cuda":
                k1 = counts.pop("K1")
                want = (k1 == QUALITY_K1_LAUNCHES
                        if run == "eval_detection_quality" else k1 > 0)
                if run in TOOLS_WITH_K1:
                    bad += [] if want and not any(counts.values()) else [
                        f"{run}: launched K1 {k1} times and {counts}"]
                elif k1 or any(counts.values()):
                    bad.append(f"{run}: launched K1 {k1} times, {counts}")
                counts["K1"] = k1
            res = {k: v for k, v in res.items()
                   if k not in ("ba_problem", "centers")}
            out[run] = {"s": secs, "argv": argv, "cut": cut,
                        "sampler_counts": counts, "result": res}
            log(f"tools: {run} ({cut}): {secs:.2f} s, sampler "
                f"{json.dumps(counts)}", json.dumps(res, default=str))
    out["sampler_counts"] = {"K1": sum(r["sampler_counts"].get("K1", 0)
                                       for r in out.values())}
    log("tools", json.dumps({k: round(v["s"], 2) for k, v in out.items()
                             if k != "sampler_counts"}),
        f"K1 launches {out['sampler_counts']['K1']} ({card})")
    check(not bad, "; ".join(bad))
    return out

# Phase "bench": the bench twin's gates. Its roofline fraction stays below
# 1 + 5% (an estimate, not a bound: the work counted is the reference's).
BENCH_ROOFLINE_GATE = 1.05


def phase_bench(ps, card: str, device="cuda", hw=None, capacity=None,
                iters=None) -> dict:
    """The bench twin ``torch_bench.py`` through its ``main`` at its
    defaults (480x640, capacity 8192, batch 1, 20 pipelined pairs; a CPU
    rehearsal may cut ``hw``, ``capacity`` and ``iters``, each cut
    printed). Gates: one JSON line on stdout with the headline metric's
    name and a finite positive value; the pipelined match counts equal the
    first batch's on the same inputs, and that within 1% of the warm-up
    pair's; the throughput path launches no sampler kernel (the default
    "gather" sampler), the quality run K1's vector variant
    ``QUALITY_K1_LAUNCHES`` times; the quality keys computed, the OpenCV
    ratios null where cv2 is absent; the roofline fraction below
    ``BENCH_ROOFLINE_GATE``. Returns the line, what ``bench_ours`` saw and
    the phase's launches."""
    import contextlib
    import io

    import torch_bench as tb

    cuts = []
    saved = (tb.load_pair, tb.TOTAL_CAP, tb.ITERS)
    if hw is not None:
        full_pair = tb.load_pair
        tb.load_pair = lambda: full_pair(*hw)
        cuts.append(f"pair {hw[0]}x{hw[1]} (default 480x640)")
    if capacity is not None:
        tb.TOTAL_CAP = capacity
        cuts.append(f"capacity {capacity} (default {saved[1]})")
    if iters is not None:
        tb.ITERS = iters
        cuts.append(f"{iters} pipelined batches (default {saved[2]})")
    log("bench: " + ("; ".join(cuts) if cuts else "nothing cut (the "
                     "twin's defaults)"))
    printed = io.StringIO()
    last = {}
    ps.reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            res = tb.main(["--device", str(device)], record=last)
    finally:
        tb.load_pair, tb.TOTAL_CAP, tb.ITERS = saved
    secs = time.perf_counter() - t0
    counts = ps.counts()
    lines = [ln for ln in printed.getvalue().splitlines() if ln.strip()]
    out = {"s": secs, "line": res, "bench_ours": last,
           "sampler_counts": counts, "cuts": cuts}
    log(f"bench: {secs:.2f} s", json.dumps(out, default=str), f"({card})")
    bad = []
    try:
        line = json.loads(lines[-1]) if len(lines) == 1 else None
    except ValueError:
        line = None
    if line is None:
        bad.append(f"stdout holds {len(lines)} lines, not one JSON line")
    elif (line.get("metric") != "two_view_sift_detect_describe_match_throughput"
          or line.get("unit") != "frames/s"
          or not (isinstance(line.get("value"), float)
                  and math.isfinite(line["value"]) and line["value"] > 0)):
        bad.append(f"the line {line}")
    pipe = last["pipelined_counts"]
    if any(c != last["first_counts"] for c in pipe):
        bad.append(f"pipelined counts {pipe} differ from the first batch's "
                   f"{last['first_counts']}")
    first = np.asarray(last["first_counts"], float)
    if np.abs(first - last["matches"]).max() > 0.01 * last["matches"]:
        bad.append(f"the first batch's matches {last['first_counts']} vs "
                   f"the warm-up pair's {last['matches']}")
    if any(last["sampler_launches"].values()):
        bad.append(f"the throughput path launched {last['sampler_launches']}")
    quality_k1 = {k: v - last["sampler_launches"][k] for k, v in counts.items()}
    if torch.device(device).type == "cuda" and (
            quality_k1.pop("K1") != QUALITY_K1_LAUNCHES
            or any(quality_k1.values())):
        bad.append(f"the quality run launched {counts}")
    try:
        import cv2  # noqa: F401
        no_cv = False
    except ImportError:
        no_cv = True
    if res.get("repeatability") is None:
        bad.append("no quality keys")
    if no_cv and any(res.get(k) is not None
                     for k in tb.OPENCV_KEYS + ("vs_baseline",)):
        bad.append("OpenCV ratios without cv2")
    if not res.get("roofline_frac", 2.0) < BENCH_ROOFLINE_GATE:
        bad.append(f"roofline fraction {res.get('roofline_frac')}")
    check(not bad, "bench: " + "; ".join(bad))
    return out


# The runs of phase "probes": (twin scripts/torch_<probe>.py, argv, the cut
# against the probe's defaults, the stage names its output prints in
# order; each name is the probe's own). A line matches a stage where it
# starts with the name, after a leading "STAGE ".
PROBE_RUNS = [
    ("probe_sift_stages", [], "nothing cut (480x640)",
     ["pyramid", "+detect", "+orient", "+descr"] * 2),
    ("probe_sift_prefix", [], "nothing cut (cap 3072, 5 refinements)",
     ["pyramid", "dog", "stencil", "detect", "gradient", "orient_maps",
      "orient_peaks", "compact", "desc", "full+merge"]),
    ("probe_trace_frontend", [], "nothing cut (cap 4096, 3 frames)",
     ["compile+first", "device total"]),
    ("probe_pallas_sampler", [], "nothing cut ((5, 480, 640, 36) bf16, "
     "K = 5120, N = 16)",
     ["xla nearest", "xla bilinear", "pallas patches",
      "pallas vs bilinear max abs err"]),
    ("probe_vo_stages", [], "nothing cut (240x320, 300 samples)",
     ["SIFT frontend", "matching", "E-RANSAC", "PnP RANSAC",
      "triangulation"]),
    ("probe_ba_stages", [], "nothing cut (C=256, P=60k, O=800k, 15 CG)",
     ["cost", "jacobians_closed", "jacobians", "gn_blocks(segsum)",
      "inv_blocks(V 3x3)", "inv_blocks(U 6x6)", "schur_matvec x1",
      "schur_matvec x", "solve_lm(full)", "LM iter (full step)"]),
    ("probe_dense_ba", [], "nothing cut (C=256, P=100k, O=800k)",
     ["Sp", "pass A (stats scan)", "dense solve ", "pass B (backsub)",
      "cost pass", "full LM iter"]),
    ("probe_dense_passA", [], "nothing cut (C=256, P=100k, O=800k)",
     ["jac", "ucat", "vw", "d", "full"]),
    ("probe_segsum", [], "nothing cut (O=800k; 256 and 60k segments)",
     ["--- ", "scatter", "scatter_sorted", "cumsum", "cumsum2"] * 2),
    ("probe_batch_parity", [], "nothing cut (5 frames at 240x320)",
     ['{"probe": "setup"', '{"probe": "detect"', '{"probe": "match"',
      '{"probe": "ransac"']),
    ("probe_ab_vo", ["--frames", "20", "--seeds", "2"],
     "20 frames and 2 seeds (default 40 and 3) at 240x320",
     ['{"mode": ', '{"mode": ', '{"summary": ', '{"summary": ']),
    ("probe_sfm_ate_stages", ["--full"],
     "nothing cut (128, 256 and 512 views, with triangulation and BA)",
     ["V=", "      triangulation: ", "      BA round "] * 3),
    ("probe_city_stages", [], "nothing cut (96 views)",
     ["edges ", "global rotations:", "final ATE", "post-averaging ATE"]),
    ("probe_dense_ablate", [], "nothing cut (C=256, P=100k, O=800k)",
     ["sps", "passA-jac", "passA-noS", "passA-", "cost", "passB", "solve",
      "full LM iter"]),
    ("probe_dense_micro", [], "nothing cut (N=1,835,008, C=256)",
     ["onehot", "rank3", "take", "pairs", "stack42", "poseMM",
      "poseGather"]),
    ("probe_desc_micro", [], "nothing cut ((3, 480, 640, 36) bf16, "
     "K = 3840)",
     ["desc: 4 gathers", "desc: wfo build", "desc: wfo+einsum",
      "desc: gemm+shift", "peaks: lowe_smooth", "peaks: find_peaks",
      "peaks: argmax-top2", "peaks: sample"]),
    ("probe_frontend_sweep", [], "nothing cut (time mode, 480x640)",
     ["base", "oct4", "refine2", "oct4+ref2", "cap4096", "cap4096+o4r2"]),
    ("probe_tracker_flat", [], "nothing cut (500 frames, cap 4096; the "
     "NumPy path to 200)",
     ["incremental (native core)", "  frame ", "  growth frame",
      "batch path", "  frame "]),
    ("probe_capacity3072", [], "nothing cut (480x640, SIFTParams())",
     ["capacity:", "frame A:", "frame B:", "matches:", "single-frame warm:",
      "relative pose:", "OK"]),
    ("probe_fault_bisect", ["all"], "every stage in one process (the "
     "probe runs one per process), cap 3072",
     ["detect", "orient", "peaks", "compact", "desc", "merge OK:"]),
    ("probe_fault_desc", ["all"], "every stage in one process (the probe "
     "runs one per process)",
     ["gather", "einsum", "full", "chunk"]),
]
# Phase "probes": the segment sums' largest errors against a float64
# reference. The scatters add each row once: within 1e-5 per segment over
# |segment| + mean |segment| (the probe's measure). A cumsum's segment is
# the difference of two rounded prefix sums, and a float32 scan's rounding
# errors add up like a random walk over its O rows: the cumsums are held
# to sqrt(O) float32 epsilons (2^-23) of the largest prefix (Higham's
# probabilistic bound, lambda = 2). The CPU's cumsum accumulates in
# float64 (0.55-1.38 epsilons at O = 800k, an 8-core Intel Xeon), the
# card's in float32.
SEGSUM_SCATTER_TOL = 1e-5
# Twin 4 on bfloat16 maps: the probe expects ~1e-2 between its kernel and
# the bilinear gather (the TPU kernel weights in bfloat16).
PROBE_BF16_TOL = 1e-2


def stages_in_order(text: str, names: list) -> list:
    """The names of ``names`` not found, in order, at the starts of the
    lines of ``text`` (a leading "STAGE " skipped)."""
    j = 0
    for ln in text.splitlines():
        ln = ln[len("STAGE "):] if ln.startswith("STAGE ") else ln
        if j < len(names) and ln.startswith(names[j]):
            j += 1
    return names[j:]


def phase_probes(ps, card: str, device="cuda", runs=None) -> dict:
    """The 21 probe twins ``scripts/torch_probe_*.py`` through their
    ``main(argv)`` at the probes' defaults (``PROBE_RUNS``, each cut
    printed). Gates: each printed every stage of its probe, in order;
    the batch probe's batched detection within 0.05 px of the single one
    for >= 95% of each frame's keypoints, its match masks differing in <=
    1% of a pair's matches and, with the same samples, its RANSAC
    successes the single ones'; every A/B VO run accepting all frames but
    one; twin 4's K1 output within ``TOLERANCE`` of its bilinear gather on
    float32 maps at the probe's shape (a comparison: not counted) and
    within ``PROBE_BF16_TOL`` on the probe's bfloat16 maps; twin 9's
    scatters within ``SEGSUM_SCATTER_TOL`` and its cumsums within sqrt(O)
    float32 epsilons of the largest prefix of the float64 sums; twin 7's pieces,
    composed, at one ``dense_schur_bundle_adjust`` iteration's cost within
    1e-6 relative, and the dense ablation's pieces at one
    ``dense_schur_bundle_adjust_strata`` iteration's; each lowering of the
    dense micro-probe within its float32 rounding bound of the float64
    product (``torch_probe_dense_micro.agreement``); the capacity probe's
    own assert (inliers > 0.9 n, R error < 0.5 deg, t error < 1 deg); the
    fault probes' every stage finite, the descriptors of all slots at
    once and in sections within ``TOLERANCE``; the SfM and city stage
    probes' errors finite at every view count (no accuracy gate: F4 fails
    in both packages). The sampler counts are set to 0 just before each
    run and read just after: twin 4 launches K1's vector variant, no other
    twin a sampler kernel. Returns each run's seconds, result, printed
    lines and launches."""
    import contextlib
    import io

    dev = torch.device(device)
    out, bad = {}, []
    for name, argv, cut, names in runs or PROBE_RUNS:
        mod = load_tool(name)
        argv = list(argv) + ["--device", str(device)]
        printed = io.StringIO()
        ps.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(printed):
            res = mod.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ps.counts()
        text = printed.getvalue()
        missing = stages_in_order(text, names)
        if missing:
            bad.append(f"{name}: no stage {missing}")
        k1 = counts.pop("K1")
        if any(counts.values()) or (dev.type == "cuda" and (
                (k1 > 0) != (name == "probe_pallas_sampler"))):
            bad.append(f"{name}: launched K1 {k1} times and {counts}")
        counts["K1"] = k1
        if name == "probe_pallas_sampler":
            bf16 = res["max_abs_err"]
            maps, si, ys, xs = mod.make_inputs(dev, torch.float32,
                                               **mod.SHAPE)
            fns = mod.samplers(maps, si)
            f32 = float((fns["pallas patches"](ys, xs)
                         - fns["xla bilinear"](ys, xs)).abs().max())
            res.update(max_abs_err_f32=f32)
            if not (f32 <= TOLERANCE and bf16 <= PROBE_BF16_TOL):
                bad.append(f"{name}: K1 vs the bilinear gather {f32} (f32),"
                           f" {bf16} (bf16)")
        elif name == "probe_segsum":
            res = {f"{label} {v}": r for (label, v), r in res.items()}
            for key, r in res.items():
                ok = (r["prefix_eps"] <= math.sqrt(r["rows"])
                      if "cumsum" in key
                      else r["max_rel_err"] <= SEGSUM_SCATTER_TOL)
                if not ok:
                    bad.append(f"{name}: {key} error {r}")
        elif name in ("probe_dense_ba", "probe_dense_ablate"):
            a, b = res["cost_composed"], res["cost_solver"]
            if not abs(a - b) <= 1e-6 * abs(b):
                bad.append(f"{name}: composed cost {a} vs solver {b}")
        elif name == "probe_dense_micro":
            ratios = mod.agreement(res.pop("outputs"), res.pop("inputs"))
            res["error_over_bound"] = ratios
            if not max(ratios.values()) <= 1.0:
                bad.append(f"{name}: lowerings beyond float32 rounding "
                           f"{ratios}")
        elif name == "probe_fault_desc" and not (
                res["full_vs_chunk"] <= TOLERANCE):
            bad.append(f"{name}: full vs chunk {res['full_vs_chunk']}")
        elif name == "probe_sfm_ate_stages":
            nums = [v for r in res.values() for k, v in r.items()
                    if k != "full"]
            nums += [v for r in res.values()
                     for b in r.get("full", {}).get("ba", [])
                     for v in b.values()]
            if len(res) != 3 or not all(math.isfinite(v) for v in nums):
                bad.append(f"{name}: {res}")
        elif name == "probe_trace_frontend" and dev.type == "cuda" and not res:
            bad.append(f"{name}: no device events")
        elif name == "probe_batch_parity":
            if min(f["frac_matched"] for f in res["detect"]["per_frame"]) \
                    < 0.95 or any(
                    p["mask_diff"] > 0.01 * p["n_single"]
                    for p in res["match"]["per_pair"]) or any(
                    p["single"]["ok"] != p["batch"]["ok"]
                    for p in res["ransac"]["per_pair"]):
                bad.append(f"{name}: batched against single {res}")
        elif name == "probe_ab_vo":
            frames = int(argv[argv.index("--frames") + 1])
            if any(r["accepted"] < frames - 1 for runs in
                   res["runs"].values() for r in runs):
                bad.append(f"{name}: {res['runs']}")
        if name in ("probe_fault_bisect", "probe_fault_desc",
                    "probe_city_stages") and not all(
                    math.isfinite(v) for v in res.values()):
            bad.append(f"{name}: not finite {res}")
        out[name] = {"s": secs, "cut": cut, "result": res,
                     "sampler_counts": counts,
                     "printed": text.strip().splitlines()}
        log(f"probes: {name} ({cut}): {secs:.2f} s, sampler "
            f"{json.dumps(counts)}", json.dumps(res, default=str))
        log("\n".join(text.strip().splitlines()))
    out["sampler_counts"] = {"K1": sum(r["sampler_counts"]["K1"]
                                       for r in out.values())}
    log("probes", json.dumps({k: round(v["s"], 2) for k, v in out.items()
                              if k != "sampler_counts"}),
        f"K1 launches {out['sampler_counts']['K1']} ({card})")
    check(not bad, "; ".join(bad))
    return out


# Phase "batch": the batched frontend at these window sizes, 480x640.
BATCH_SIZES = (1, 4, 8)
# A window of 8 frames launches at most this many times B = 1's device
# operations (the launches of one frame, not eight).
BATCH_LAUNCH_RATIO = 1.2
# A frame of a batch against the frame alone: the share of its keypoints
# within 0.5 px and 1% in scale, and of its matches (position pairs within
# 0.5 px) on pairs of >= 100 matches. cuDNN may round a batch's blurs
# unlike one frame's, which flips borderline extrema.
BATCH_OVERLAP_FLOOR = 0.98
BATCH_MATCH_FLOOR = 0.95


def batch_frames(n: int, hw=FRAME_HW) -> np.ndarray:
    """(n, h, w): the frame pair of phase 4 (A, then B = A shifted 16 px),
    then renders of the VO loop through ``make_room(seed=1)``."""
    h, w = hw
    tex = texture(1, h, w + SHIFT_PX)
    _, room, _ = vo_frames(max(n - 2, 0), hw)
    return np.stack([tex[:, SHIFT_PX:], tex[:, :w]] + room)[:n]


def match_share(la, ra, mask_a, j_a, lb, rb, mask_b, j_b) -> tuple:
    """(share of matches a, as (left xy, right xy) pairs, with a pair of b
    within 0.5 px in every coordinate; the number of a's matches).
    Tensors on one device."""
    pa = torch.cat([la[mask_a], ra[j_a[mask_a].long()]], dim=1)
    pb = torch.cat([lb[mask_b], rb[j_b[mask_b].long()]], dim=1)
    if len(pa) == 0:
        return 1.0, 0
    if len(pb) == 0:
        return 0.0, len(pa)
    d = torch.cdist(pa[None], pb[None], p=float("inf"))[0].amin(dim=1)
    return float((d < 0.5).double().mean()), len(pa)


def measure_window(ps, fn, B: int, on_card: bool, what: str,
                   recorded: list | None = None) -> tuple:
    """One window ``fn`` of B frames: a warm-up call, one counted call
    (the sampler counts set to 0 just before and read just after; with
    ``recorded``, each K1 launch's inputs and output appended), then the
    median of 3 timed calls, each ending in a synchronize; on the card
    also the counted call's peak memory, the host syncs of one call and a
    profile's device operations. Returns (the counted call's result, the
    record)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    fn()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    wrapper = ps.sample_field_patches

    def recording(*args, **kwargs):
        res = wrapper(*args, **kwargs)
        recorded.append((args[:4], res))
        return res

    if recorded is not None:
        ps.sample_field_patches = recording
    try:
        ps.reset_counts()
        t0 = time.perf_counter()
        result = fn()
        sync()
        rec = {"B": B, "first_ms": (time.perf_counter() - t0) * 1e3,
               "sampler_counts": ps.counts()}
    finally:
        ps.sample_field_patches = wrapper
    if on_card:
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    rec["ms_per_window"] = float(np.median(times))
    rec["frames_per_s"] = 1e3 * B / rec["ms_per_window"]
    if on_card:
        rec["syncs"] = count_syncs(fn)
        prof = profile_frame(fn, rec["ms_per_window"], what=what)
        rec["device_ops"] = prof["device_ops"] if prof else None
        rec["device_busy_ms"] = prof["device_busy_ms"] if prof else None
    return result, rec


def phase_batch(ps, card: str, device="cuda", hw=FRAME_HW,
                sizes=BATCH_SIZES, bench_batch: int = 4) -> dict:
    """The batched frontend: windows of B = ``sizes`` frames of
    ``batch_frames`` through ``_compute_sift_batch`` (the kernel sampler,
    bilinear, phase 4's configuration) and one ``_match_sets`` over the
    window's pairs (frame k against frame k - 1, frame 0 against frame 0
    alone), then VO's ``_fused_frontend_batch`` on the room frames
    (``vo_config``), then ``torch_bench.main`` at ``SARA_BENCH_BATCH`` =
    ``bench_batch``.

    Per B it records ms per window and frames/s (host clock, median of 3
    after a warm-up, each ending in a synchronize), device operations
    (a profile), host syncs of the detection + matching (gate: 0) and of
    the fused window (with E-RANSAC; logged), peak memory, and K1's
    launches, counted from 0 just before and read just after one window:
    one per octave whatever B (gate), no other kernel. Gates besides: each
    frame's keypoints overlap the frame alone by ``BATCH_OVERLAP_FLOOR``
    and its counts within 2%; the match sets of pairs of >= 100 matches
    share ``BATCH_MATCH_FLOOR``; B = max's device operations at most
    ``BATCH_LAUNCH_RATIO`` x B = 1's; every K1 output of B = max's window
    (the frame-folded field) within ``TOLERANCE`` of the plain version (a
    comparison of recorded outputs: no launch); the bench line's metric
    finite and positive, its pipelined counts those of its first batch and
    within 1% of the warm-up pair's matches, no sampler launch on its
    throughput path. Returns the measurements and K1's launches."""
    import contextlib
    import io

    import torch_bench as tb
    from sara_tpu_torch.features.api import (SIFTParams, _compute_sift_batch,
                                             compute_sift_keypoints)
    from sara_tpu_torch.image.pyramid import gaussian_pyramid
    from sara_tpu_torch.matching.brute_force import (MatchParams,
                                                     _match_sets,
                                                     match_descriptors)
    from sara_tpu_torch.sfm.odometry import _fused_frontend_batch
    from sara_tpu_torch.utils.host import fetch, put

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    params = SIFTParams(desc_sampler="kernel", desc_sample_nearest=False)
    mp = MatchParams(ratio=0.8)
    nmax = max(sizes)
    stack = put(batch_frames(nmax, hw), dev)
    n_oct = len(gaussian_pyramid(stack[0], params.pyramid).octaves)
    singles = [compute_sift_keypoints(stack[f], params, device=dev)
               for f in range(nmax)]
    single_m = [match_descriptors(singles[max(f - 1, 0)], singles[f], mp,
                                  device=dev) for f in range(nmax)]
    single_h = [fetch(k.xy, k.scale, k.mask) for k in singles]
    out, bad, k1_total = {"sizes": {}}, [], 0

    def window(sub):
        kb = _compute_sift_batch(sub, params, device=dev)
        left = type(kb)(*(torch.cat([f[:1], f[:-1]]) for f in kb))
        j, ok, _ = _match_sets(left.descriptors, left.mask, kb.descriptors,
                               kb.mask, mp.ratio, mp.mutual)
        return kb, left, j, ok

    for B in sizes:
        sub = stack[:B]
        recorded = []
        (kb, left, j, ok), rec = measure_window(
            ps, lambda: window(sub), B, on_card, f"batch window B={B}",
            recorded)
        counts = rec["sampler_counts"]
        k1_total += counts["K1"]
        if on_card:
            rec["k1_max_abs_err"] = max(
                float((res - ps._sample_patches_reference(*args)).abs().max())
                for args, res in recorded)
            if not rec["k1_max_abs_err"] <= TOLERANCE:
                bad.append(f"B={B}: K1 vs plain {rec['k1_max_abs_err']}")
            want = {"K1": n_oct, "K1 general": 0, "K2": 0,
                    "K2 general": 0, "index copies": 0}
            if counts != want:
                bad.append(f"B={B}: launches {counts}, not one K1 per "
                           f"octave ({n_oct})")
            if rec["syncs"]["syncs"]:
                bad.append(f"B={B}: detection + matching synced "
                           f"{rec['syncs']}")
        # Against the frames alone: keypoints and match sets.
        xy, sc, mk = fetch(kb.xy, kb.scale, kb.mask)
        overlaps, shares = [], []
        for f in range(B):
            sxy, ssc, smk = single_h[f]
            overlaps.append(kp_overlap(xy[f][mk[f]], sc[f][mk[f]],
                                       sxy[smk], ssc[smk]))
            if abs(int(mk[f].sum()) - int(smk.sum())) > 0.02 * smk.sum():
                bad.append(f"B={B} frame {f}: {int(mk[f].sum())} keypoints "
                           f"against {int(smk.sum())} alone")
            sm = single_m[f]
            share, n = match_share(
                singles[max(f - 1, 0)].xy, singles[f].xy, sm.mask, sm.j,
                left.xy[f], kb.xy[f], ok[f], j[f])
            shares.append((share, n))
            if n >= 100 and share < BATCH_MATCH_FLOOR:
                bad.append(f"B={B} pair {f}: match share {share} of {n}")
        rec["kp_overlap"] = overlaps
        rec["match_share"] = shares
        if min(overlaps) < BATCH_OVERLAP_FLOOR:
            bad.append(f"B={B}: keypoint overlap {overlaps}")
        out["sizes"][B] = rec
        log(f"batch: B={B}", json.dumps(rec, default=str), f"({card})")

    # VO's fused window on the room frames (frames 2..), vo_config.
    cfg = vo_config()
    K, room, _ = vo_frames(nmax + 1, hw)
    room_dev = put(np.stack(room), dev)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    prev = compute_sift_keypoints(room_dev[0], cfg.sift, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fused(B):
        return _fused_frontend_batch(
            room_dev[1:B + 1], None, None, prev, gen, Kt, cfg.sift,
            cfg.match_ratio, cfg.rel_pose_threshold_px,
            cfg.rel_pose_samples_fast, cfg.rel_pose_min_inliers, False)

    out["fused"] = {}
    for B in sizes:
        (_, _, res, _, _), rec = measure_window(
            ps, lambda: fused(B), B, on_card, f"fused window B={B}")
        rec["success"] = fetch(res.success)[0].tolist()
        k1_total += rec["sampler_counts"]["K1"]
        if not all(rec["success"]):
            bad.append(f"fused B={B}: successes {rec['success']}")
        out["fused"][B] = rec
        log(f"batch: fused window B={B}", json.dumps(rec, default=str),
            f"({card})")

    if on_card:
        for key in ("sizes", "fused"):
            ops = [out[key][B].get("device_ops") for B in (min(sizes), nmax)]
            out[f"{key}_launch_ratio"] = (ops[1] / ops[0] if all(ops)
                                          else None)
            if not (out[f"{key}_launch_ratio"] or 2.0) <= BATCH_LAUNCH_RATIO:
                bad.append(f"{key}: device operations {ops} at B = "
                           f"{min(sizes)}, {nmax}")

    # The bench twin at SARA_BENCH_BATCH = bench_batch.
    saved = (tb.BATCH, tb.ITERS, tb.load_pair)
    tb.BATCH, tb.ITERS = bench_batch, 5
    if tuple(hw) != FRAME_HW:
        full_pair = tb.load_pair
        tb.load_pair = lambda: full_pair(*hw)
    last = {}
    ps.reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            line = tb.main(["--device", str(device)], record=last)
    finally:
        tb.BATCH, tb.ITERS, tb.load_pair = saved
    k1_total += ps.counts()["K1"]
    out["bench"] = {"s": time.perf_counter() - t0, "line": line,
                    "bench_ours": last}
    log(f"batch: torch_bench at SARA_BENCH_BATCH={bench_batch}",
        json.dumps(out["bench"], default=str), f"({card})")
    value = line.get("value")
    if not (isinstance(value, float) and math.isfinite(value) and value > 0):
        bad.append(f"bench: the line {line}")
    first = np.asarray(last["first_counts"], float)
    if (any(c != last["first_counts"] for c in last["pipelined_counts"])
            or np.abs(first - last["matches"]).max()
            > 0.01 * last["matches"] or len(first) != bench_batch):
        bad.append(f"bench: counts {last['first_counts']}, "
                   f"{last['pipelined_counts']}, {last['matches']}")
    if any(last["sampler_launches"].values()):
        bad.append(f"bench: throughput path launched "
                   f"{last['sampler_launches']}")
    out["k1_launches"] = k1_total
    check(not bad, "batch: " + "; ".join(bad))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    from sara_tpu_torch.ops import _build, patch_sampler as ps

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(*_build.kernel_names())
    log(f"kernels {_build.kernel_names()} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        log(f"{name} phase: {time.perf_counter() - t:.2f} s")
        return result

    worst = timed("kernels vs plain", phase_kernels_vs_plain, ps)
    recorded, launches, frames = timed("frame", phase_main_path, ps, card)
    k2_launches, k1_on_k2_path, k2_path_err = timed(
        "pack_x", phase_packed_path, ps, recorded)
    rows = timed("K1 timing", phase_timing, ps, recorded)
    rows_k2 = timed("K2 timing", phase_timing, ps, recorded, packed=True)
    _, lp_launches, lp_err = timed("low precision", phase_low_precision, ps,
                                   card)
    timed("K1 vs K2", compare_k1_k2, ps, recorded)
    timed("two-view", phase_two_view, frames, card)
    vo = timed("vo", phase_vo, ps, card)
    timed("ba", phase_ba, card)
    loop = timed("loop", phase_loop, ps, card)
    timed("global_sfm", phase_global_sfm, card)
    city, city_prob, city_part = timed("city", phase_city, card)
    timed("dist", phase_dist, card, city_prob, city_part, frames)
    timed("calib", phase_calib, card)
    dt = timed("detect_track", phase_detect_track, ps, card)
    pr = timed("propagation", phase_propagation, ps, card, frames)
    e3 = timed("e3", phase_e3, ps, card)
    demos = timed("demos", phase_demos, ps, card)
    tools = timed("tools", phase_tools, ps, card)
    bench = timed("bench", phase_bench, ps, card)
    probes = timed("probes", phase_probes, ps, card)
    batch = timed("batch", phase_batch, ps, card)
    import torch.distributed as dist

    dist.destroy_process_group()
    check(not any(m.split(".")[0] in ("jax", "sara_tpu")
                  for m in sys.modules), "JAX or sara_tpu was imported")

    def entry(name, kname, replaces, rows, launches, worst_path, per,
              **extra):
        total = {k: sum(r[k] for r in rows)
                 for k in ("ms", "old_ms", "plain_ms", "library_ms",
                           "bound_ms", "floor_ms", "copy_ms")}
        return {
            "name": name, "route": "cuda",
            "source": "sara_tpu_torch/ops/csrc/patch_sampler.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max([worst[kname, "vector"], worst_path]
                               + [r["max_abs_err"] for r in rows]),
            "ms": total["ms"], "kernel_ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": total["library_ms"],
            "floor_ms": total["floor_ms"], "copy_ms": total["copy_ms"],
            "old_ms": total["old_ms"],
            "old": "the general variant (one thread per output element, "
                   "the first Hopper kernel), timed in turns with the vector "
                   "variant",
            "old_max_abs_err": max([worst[kname, "general"]]
                                   + [r["old_max_abs_err"] for r in rows]),
            "per": per, **extra}

    kernels = [
        entry("patch_sampler", "K1", "sara_tpu/ops/patch_sampler.py:170",
              rows, launches + k1_on_k2_path + vo["sampler_counts"]["K1"]
              + loop["sampler_counts"]["K1"] + lp_launches
              + tools["sampler_counts"]["K1"]
              + bench["sampler_counts"]["K1"]
              + probes["sampler_counts"]["K1"] + batch["k1_launches"],
              lp_err, "frame: the 6 launches of one 480x640 frame, summed",
              launches_by_path={"frames": launches,
                                "pack_x": k1_on_k2_path,
                                "low_precision": lp_launches,
                                "vo": vo["sampler_counts"]["K1"],
                                "loop": loop["sampler_counts"]["K1"],
                                "detect_track": dt["sampler_counts"]["K1"],
                                "propagation": pr["sampler_counts"]["K1"],
                                "e3": e3["sampler_counts"]["K1"],
                                "demos": demos["sampler_counts"]["K1"],
                                "tools": tools["sampler_counts"]["K1"],
                                "bench": bench["sampler_counts"]["K1"],
                                "probes": probes["sampler_counts"]["K1"],
                                "batch": batch["k1_launches"]}),
        entry("patch_sampler_packed", "K2",
              "sara_tpu/ops/patch_sampler.py:236", rows_k2, k2_launches,
              k2_path_err,
              "frame: the 5 pack_x launches (octaves 0-4) of one 480x640 "
              "frame, summed"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
