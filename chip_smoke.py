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
   ``process_frames``), the sampler counts set to 0 just before and read
   just after: at least 29 accepted, ATE <= 0.10, > 500 map points, K1's
   vector variant on every frame, the native union-find; records ms per
   frame and per stage, BA ms per call, host syncs and a profile;
9. phase "ba": ``scripts/bench_ba.py``'s "large" problem (C=256,
   P=100,000, O=800,000, float32) through ``bundle_adjust`` (dense Schur),
   a ``DenseSchurSession`` solved twice and ``bundle_adjust_cg``, 10 LM
   iterations each: every cost falls, dense and CG within 1%, the session
   continues; records ms per LM iteration, syncs, peak memory, a profile;
10. print the kernels line, the card line, then the result line.
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
    busy time beside the unprofiled wall time, and the kernels that take
    the most of it. Prints "not measured" if the profiler sees no device
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
        return
    events.sort(key=dev_us, reverse=True)
    log(f"{what} profile", json.dumps({
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [{"name": e.key[:80], "calls": e.count,
                 "device_ms": dev_us(e) / 1e3} for e in events[:top]]}))


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
    """The host syncs PyTorch reports in one call of ``fn``
    (``torch.cuda.set_sync_debug_mode("warn")``): their count and the
    source lines (file:line) that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{w.filename.split('/')[-1]}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return {"syncs": len(where),
            "at": {k: where.count(k) for k in sorted(set(where))}}


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


def load_render3d():
    """``tests/render3d.py`` (numpy + scipy) from the checkout, by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "render3d.py"
    spec = importlib.util.spec_from_file_location("render3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vo_frames(n: int, hw=VO_HW, first: int = 0):
    """Frames ``first`` .. ``first + n - 1`` of the circular loop of
    scripts/eval_vo.py (100 poses, a = 2 pi i / 100, gentle yaw) through
    ``make_room(seed=1)``: (K, images, camera centres)."""
    r3 = load_render3d()
    h, w = hw
    K = np.array([[0.94 * w, 0, w / 2], [0, 0.94 * w, h / 2], [0, 0, 1.0]])
    planes = r3.make_room(seed=1)
    imgs, centers = [], []
    for i in range(first, first + n):
        a = 2 * np.pi * i / VO_LOOP
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
    rest by ``process_frames`` (window 4). The sampler counts are set to 0
    just before and read just after. Gates: all frames but one accepted,
    ATE <= 0.10 after similarity alignment, > 500 map points, the native
    union-find, and on the card K1's vector variant on every frame with no
    index copy. Records steady ms per frame, the steady frames' time per
    stage (detection, relative pose, PnP, BA, the rest) and BA ms per call.
    Then two more frames of the loop, with the stage timers removed: one
    for the host syncs, one profiled. Returns the measurements."""
    from sara_tpu_torch.features.api import compute_sift_keypoints
    from sara_tpu_torch.sfm import OdometryPipeline
    from sara_tpu_torch.sfm import disjoint_sets
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
    stage_ms = {name: [] for name in VO_STAGES}

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
           "k1_per_frame": per_frame, "sampler_counts": counts,
           "union_find": backend}
    log("vo", json.dumps(out), f"({card})")
    check(accepted >= n_frames - 1, f"vo: {accepted}/{n_frames} accepted")
    check(ate <= 0.10, f"vo: ATE {ate}")
    check(out["map_points"] > 500, f"vo: {out['map_points']} map points")
    if dev.type == "cuda":
        check(per_frame >= 1 and counts == {
            "K1": n_frames * per_frame, "K1 general": 0, "K2": 0,
            "K2 general": 0, "index copies": 0},
            f"vo: expected {n_frames} x {per_frame} launches of K1's vector "
            f"variant and nothing else, got {counts}")
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
    timed("K1 vs K2", compare_k1_k2, ps, recorded)
    timed("two-view", phase_two_view, frames, card)
    vo = timed("vo", phase_vo, ps, card)
    timed("ba", phase_ba, card)
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
              rows, launches + k1_on_k2_path + vo["sampler_counts"]["K1"],
              0.0, "frame: the 6 launches of one 480x640 frame, summed",
              launches_by_path={"frames": launches,
                                "pack_x": k1_on_k2_path,
                                "vo": vo["sampler_counts"]["K1"]}),
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
