#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sara_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or ``sara_tpu``. Phases (a failure in any of them
raises, so the script exits nonzero and prints no result line):

1. require a CUDA device; print the card's name and power limit;
2. build every CUDA kernel of the main path from the sources in
   ``sara_tpu_torch/ops/csrc`` (one nvcc process each, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (max abs error <= 1e-5);
4. drive the main path through the entry points a user calls: two 480x640
   frames (B is A shifted 16 px) through ``compute_sift_keypoints`` with the
   bilinear kernel-sampler configuration, then ``match_descriptors``. The
   launch counts are set to 0 just before and read just after; then check
   the keypoints, the 16-px shift of the matches, and that the gather
   sampler gives the same keypoints and descriptors;
5. time each kernel, its plain version and a PyTorch library call on the
   inputs the main path gave it, beside the card's bound for that work;
6. print the kernels line, then the result line.
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
                    edge=False, dtype=torch.float32):
    dev = torch.device("cuda")
    maps = torch.rand((S, H, W, C), generator=g, device=dev).to(dtype)
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
    si = torch.randint(0, S, (K,), generator=g, device=dev, dtype=torch.int32)
    return maps, si, ys, xs


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
    nbytes = (K * N * C * 4 + 2 * K * N * 4 + K * 4
              + n_rows * C * maps.element_size())
    flops = 13 * K * N * C
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels_vs_plain(ps) -> float:
    """K1 against its plain version on synthetic cases at the main path's
    shapes: octave 0 (random and edge-pinned centres, f32 and bf16), a
    ragged K = 13, and the octave-5 shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [("octave0", dict(S=5, H=960, W=1280, K=5120)),
             ("octave0 edge", dict(S=5, H=960, W=1280, K=5120, edge=True)),
             ("octave0 bf16", dict(S=5, H=960, W=1280, K=5120,
                                   dtype=torch.bfloat16)),
             ("K=13", dict(S=5, H=120, W=160, K=13)),
             ("octave5", dict(S=5, H=30, W=40, K=80))]
    worst = 0.0
    for name, kw in cases:
        maps, si, ys, xs = sampler_problem(g, **kw)
        out = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7)
        ref = ps._sample_patches_reference(maps, si, ys, xs)
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"{name}: shape {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        log(f"patch_sampler vs plain [{name}] {tuple(maps.shape)} "
            f"K={ys.shape[0]}: max_abs_err={err:.3e}")
        check(err <= TOLERANCE, f"patch_sampler {name}: error {err}")
        worst = max(worst, err)
    return worst


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
        ps.LAUNCHES = 0
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
        launches = ps.LAUNCHES
    finally:
        ps.sample_field_patches = wrapper
    times = [(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3]
    log(f"main path: frame A {times[0]:.2f} ms, frame B {times[1]:.2f} ms, "
        f"match {times[2]:.2f} ms ({card})")
    log(f"patch_sampler launches on the main path: {launches}")
    check(launches == 12, f"expected 12 launches (6 octaves x 2 frames), "
          f"got {launches}")

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
    return recorded[:6], launches


def profile_frame(fn, wall_ms: float, top: int = 12) -> None:
    """Where one frame's device time goes (torch.profiler): the device's
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
        log("frame profile: device time not measured (no device events)")
        return
    events.sort(key=dev_us, reverse=True)
    log("frame profile", json.dumps({
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [{"name": e.key[:80], "calls": e.count,
                 "device_ms": dev_us(e) / 1e3} for e in events[:top]]}))


def phase_timing(ps, recorded):
    """Kernel, plain version and library call on each frame-A launch's own
    inputs, beside the bound; returns per-launch rows."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for octave, (maps, s_idx, ys, xs) in enumerate(recorded):
        s32 = s_idx.to(torch.int32)
        out = ps.sample_field_patches(maps, s32, ys, xs, max_sample_radius=0)
        ref = ps._sample_patches_reference(maps, s32, ys, xs)
        lib_call, lib_view = sampler_library_call(maps, s32, ys, xs)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        lib_err = (lib_view(lib_call()) - out).abs().max().item()
        check(err <= TOLERANCE, f"octave {octave}: kernel vs plain {err}")
        bound, bound_by = sampler_bound_ms(maps, s32, ys, xs)
        row = {
            "octave": octave, "maps": list(maps.shape), "K": ys.shape[0],
            "N": ys.shape[1], "max_abs_err": err,
            "ms": timed_ms(lambda: ps.sample_field_patches(
                maps, s32, ys, xs, max_sample_radius=0), flush=flush),
            "plain_ms": timed_ms(lambda: ps._sample_patches_reference(
                maps, s32, ys, xs), flush=flush),
            "library_ms": timed_ms(lib_call, flush=flush),
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by,
        }
        log("patch_sampler at main-path shape", json.dumps(row))
        rows.append(row)
    return rows


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

    worst = phase_kernels_vs_plain(ps)
    recorded, launches = phase_main_path(ps, card)
    rows = phase_timing(ps, recorded)
    worst = max([worst] + [r["max_abs_err"] for r in rows])
    check(not any(m.split(".")[0] in ("jax", "sara_tpu")
                  for m in sys.modules), "JAX or sara_tpu was imported")

    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernel = {
        "name": "patch_sampler",
        "route": "cuda",
        "source": "sara_tpu_torch/ops/csrc/patch_sampler.cu",
        "replaces": "sara_tpu/ops/patch_sampler.py:43",
        "launches": launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": total["library_ms"],
        "per": "frame: the 6 launches of one 480x640 frame, summed",
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
