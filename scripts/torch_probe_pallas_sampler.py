"""Same-process A/B of the port's patch-sampler kernel K1 against row
gathers.

Twin of ``scripts/probe_pallas_sampler.py``. Shapes mirror the dominant
octave of the 480x640 ``first_octave=-1`` frontend: maps (5, 480, 640, 36)
bfloat16, K = 5120 descriptor slots x 16 bin centres. It times, as the
median of ``REPS`` calls after a warm-up (CUDA events after a synchronize
on the card, the host clock on the CPU), each of ``INNER`` perturbed
inputs in one call as the probe's program does:
  - nearest row gathers (``index_select``; the probe's "xla nearest"),
  - bilinear row gathers (four taps; "xla bilinear"),
  - ``ops/patch_sampler.py::sample_field_patches`` ("pallas patches"): the
    CUDA kernel K1 on the card, its plain version on the CPU;
then K1's max abs error against the bilinear gather.

It imports only ``sara_tpu_torch`` and numpy, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_pallas_sampler.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SHAPE = dict(S=5, H=480, W=640, C=36, K=5120, N=16)
RAD = 13.0  # max bin-centre spread from the centroid, map px (sigma 4.03)
INNER = 10  # perturbed inputs per timed call, as the probe's program
REPS = 4
STAGES = ("xla nearest", "xla bilinear", "pallas patches")


def make_inputs(device, dtype, S, H, W, C, K, N, seed=0):
    """The probe's seeded maps (rounded to ``dtype``), slice indices and
    sample positions, on ``device``."""
    import torch

    rs = np.random.RandomState(seed)
    maps = torch.as_tensor(rs.rand(S, H, W, C).astype(np.float32))
    cy = rs.uniform(0, H - 1, K)
    cx = rs.uniform(0, W - 1, K)
    ys = (cy[:, None] + rs.uniform(-RAD, RAD, (K, N))).astype(np.float32)
    xs = (cx[:, None] + rs.uniform(-RAD, RAD, (K, N))).astype(np.float32)
    si = rs.randint(0, S, K).astype(np.int32)
    return (maps.to(device, dtype).contiguous(),
            torch.as_tensor(si, device=device),
            torch.as_tensor(ys, device=device),
            torch.as_tensor(xs, device=device))


def samplers(maps, si):
    """The three samplers of the probe by its names, each (ys, xs) ->
    (K, N, C) float32."""
    import torch

    from sara_tpu_torch.ops.patch_sampler import sample_field_patches

    S, H, W, C = maps.shape
    flat = maps.reshape(S * H * W, C)
    base = si.long()[:, None] * (H * W)

    def take(yy, xx):
        lin = (base + yy * W + xx).reshape(-1)
        return flat.index_select(0, lin).reshape(*yy.shape, C).float()

    def nearest(ys, xs):
        yn = torch.round(ys.clamp(0, H - 1)).long()
        xn = torch.round(xs.clamp(0, W - 1)).long()
        return take(yn, xn)

    def bilinear(ys, xs):
        yc = ys.clamp(0, H - 1)
        xc = xs.clamp(0, W - 1)
        y0 = torch.floor(yc).long()
        x0 = torch.floor(xc).long()
        y1 = torch.clamp(y0 + 1, max=H - 1)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        fy = (yc - y0)[..., None]
        fx = (xc - x0)[..., None]
        return (take(y0, x0) * (1 - fx) * (1 - fy)
                + take(y0, x1) * fx * (1 - fy)
                + take(y1, x0) * (1 - fx) * fy
                + take(y1, x1) * fx * fy)

    def kernel(ys, xs):
        return sample_field_patches(maps, si, ys, xs, max_sample_radius=RAD)

    return dict(zip(STAGES, (nearest, bilinear, kernel)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    maps, si, ys, xs = make_inputs(dev, torch.bfloat16, **SHAPE)
    routes = {"xla nearest": "index_select row gathers",
              "xla bilinear": "index_select, four taps",
              "pallas patches": "sample_field_patches: K1 on the card, its "
                                "plain version on the CPU"}
    results, outs = {}, {}
    for name, fn in samplers(maps, si).items():
        def many(fn=fn):
            acc = 0.0
            for it in range(INNER):
                acc = acc + fn(ys + 0.01 * it, xs + 0.01 * it).sum()
            return acc

        _, dt, first = median_ms(many, dev, REPS)
        results[name] = dt / INNER
        print(f"{name:18s} {dt / INNER:7.3f} ms/iter (median of {REPS} x "
              f"{INNER}; first call {first:.1f}s; {routes[name]})",
              flush=True)
        outs[name] = fn(ys, xs)
    err = float((outs["pallas patches"] - outs["xla bilinear"]).abs().max())
    print(f"pallas vs bilinear max abs err: {err:.4f} "
          f"(bf16 maps -> expect ~1e-2)", flush=True)
    results["max_abs_err"] = err
    return results


if __name__ == "__main__":
    main()
