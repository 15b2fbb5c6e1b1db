"""Fine-grained cumulative-prefix timing of the PyTorch / CUDA port's SIFT
frontend.

Twin of ``scripts/probe_sift_prefix.py``. Each prefix runs the port's
per-octave steps (``features/api.py::_process_octave``) up to one stage:
pyramid, DoG, the stencil's extrema, detection (refinement, peaks,
compaction of the candidates), gradients, orientation maps, orientation
peaks, the compaction of the described slots, descriptors; then the whole
``compute_sift_keypoints`` with the merge. Each is timed as the median of
``ITERS`` calls after a warm-up call (CUDA events after a synchronize on
the card, the host clock on the CPU). The DELTA between consecutive
prefixes attributes time to one stage; the deltas subtract medians, and
the host's pace moves the launches between calls, so trust the big
deltas, not the small ones.

The image is ``torch_bench.load_pair``'s first (the reference's photograph,
else the seeded noise). It imports only ``sara_tpu_torch`` and numpy, and
runs on the card unless ``--device cpu`` is given; without a card it
raises.

Usage: python scripts/torch_probe_sift_prefix.py [cap] [refine_iters]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torch_bench import load_pair  # noqa: E402

ITERS = 8
STAGES = ("pyramid", "dog", "stencil", "detect", "gradient", "orient_maps",
          "orient_peaks", "compact", "desc")


def per_octave(stage, image, p):
    """The frontend up to ``stage`` on every octave, reduced to a sum."""
    import torch

    from sara_tpu_torch.features.dog import _stencil_extrema, detect_dog_octave
    from sara_tpu_torch.features.orientation import (find_orientation_peaks,
                                                     lowe_smooth,
                                                     orientation_maps,
                                                     sample_orientation_maps)
    from sara_tpu_torch.features.sift import sift_descriptors_field
    from sara_tpu_torch.image.differential import gradient
    from sara_tpu_torch.image.pyramid import dog_pyramid, gaussian_pyramid

    gp = gaussian_pyramid(image, p.pyramid)
    if stage == "pyramid":
        return sum(o[-1].sum() for o in gp.octaves)
    dg = dog_pyramid(gp)
    if stage == "dog":
        return sum(o[-1].sum() for o in dg.octaves)
    acc = 0.0
    for gauss, dog in zip(gp.octaves, dg.octaves):
        s_, h_, w_ = dog.shape
        cap = min(p.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        if stage == "stencil":
            mx, mn = _stencil_extrema(dog)
            acc = acc + mx.sum() + mn.sum()
            continue
        det = detect_dog_octave(dog, dataclasses.replace(p.dog, capacity=cap))
        if stage == "detect":
            acc = acc + det["x"].sum() + det["mask"].sum()
            continue
        gx, gy = gradient(gauss[:-1])
        if stage == "gradient":
            acc = acc + gx.sum() + gy.sum()
            continue
        cdt = torch.bfloat16 if p.low_precision else None
        ds = (p.orientation_downsample if p.orientation_downsample > 0
              else (2 if cdt is not None else 1))
        maps = orientation_maps(gx, gy, gp.sigmas[:-1], compute_dtype=cdt,
                                downsample=ds)
        if stage == "orient_maps":
            acc = acc + maps.float().sum()
            continue
        hist = lowe_smooth(sample_orientation_maps(
            maps, det["x"], det["y"], det["s"], downsample=ds,
            bilinear=not p.hist_sample_nearest))
        theta, tvalid = find_orientation_peaks(
            hist, max_peaks=p.max_orientations)
        if stage == "orient_peaks":
            acc = acc + theta.sum() + tvalid.sum()
            continue
        K = det["x"].shape[0]
        P = p.max_orientations
        x, y, s, mask = (det[k].repeat_interleave(P)
                         for k in ("x", "y", "s", "mask"))
        mask = mask & tvalid.reshape(-1)
        th = theta.reshape(-1)
        K2 = K + K // 4
        order = torch.argsort((~mask).to(torch.int32), stable=True)[:K2]
        x, y, s, th, mask = (t[order] for t in (x, y, s, th, mask))
        if stage == "compact":
            acc = acc + x.sum() + mask.sum()
            continue
        desc = sift_descriptors_field(
            maps, x, y, s, th, gp.sigmas[:-1], downsample=ds,
            bilinear=not p.desc_sample_nearest, sampler=p.desc_sampler)
        acc = acc + desc.float().sum() + mask.sum()
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cap", nargs="?", type=int, default=3072)
    ap.add_argument("refine_iters", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features.api import (SIFTParams,
                                             compute_sift_keypoints)
    from sara_tpu_torch.features.dog import DoGParams
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, "cap:", args.cap, "refine:", args.refine_iters,
          flush=True)
    a = torch.as_tensor(load_pair()[0]).to(dev)
    params = SIFTParams(dog=DoGParams(capacity=args.cap,
                                      refine_iters=args.refine_iters))

    results = {}
    prev = 0.0
    fns = [(st, lambda st=st: per_octave(st, a, params)) for st in STAGES]
    fns.append(("full+merge",
                lambda: compute_sift_keypoints(a, params, device=dev)))
    for st, fn in fns:
        _, dt, first = median_ms(fn, dev, ITERS)
        print(f"{st:14s} cum {dt:7.1f} ms  delta {dt-prev:7.1f} ms  "
              f"(first call {first:.1f}s)", flush=True)
        results[st] = dt
        prev = dt
    return results


if __name__ == "__main__":
    main()
