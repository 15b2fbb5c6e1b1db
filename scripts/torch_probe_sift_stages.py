#!/usr/bin/env python
"""Per-stage SIFT timing of the PyTorch / CUDA port.

Twin of ``scripts/probe_sift_stages.py``. Times cumulative prefixes of the
frontend (pyramid -> +detect -> +orientation -> +descriptor), each through
the port's own functions, as the median of ``ITERS`` calls after a warm-up
call: CUDA events after a synchronize on the card, the host clock on the
CPU. A prefix's delta over the one before attributes time to one stage;
the deltas subtract medians, not single runs, and the host's pace moves
the launches between calls, so trust the large deltas. The pair is
``torch_bench.load_pair``'s (the reference's photographs, else the seeded
noise pair). Mirrors the reference's per-stage logs
(reference: cpp/src/DO/Sara/FeatureDetectors/SIFT.cpp:56-105).

It imports only ``sara_tpu_torch`` and numpy, logs to stderr, and runs on
the card unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_sift_stages.py [--device cpu]
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
STAGES = ("pyramid", "+detect", "+orient", "+descr")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def octave_params(p, dog):
    """The adaptive per-octave detector capacity of
    ``compute_sift_keypoints``."""
    s_, h_, w_ = dog.shape
    cap = min(p.dog.capacity, max(64, (s_ * h_ * w_) // 512))
    return dataclasses.replace(p.dog, capacity=cap)


def stage_fns(img, params):
    """The four prefixes as functions of no argument, by name; each
    returns its last stage's output (the last one the ``Keypoints``)."""
    from sara_tpu_torch.features.api import compute_sift_keypoints
    from sara_tpu_torch.features.dog import detect_dog_octave
    from sara_tpu_torch.features.orientation import dominant_orientations
    from sara_tpu_torch.image.differential import gradient
    from sara_tpu_torch.image.pyramid import dog_pyramid, gaussian_pyramid

    p = params

    def pyramid():
        gp = gaussian_pyramid(img, p.pyramid)
        return sum(o[-1].sum() for o in gp.octaves)

    def detections(gp):
        dg = dog_pyramid(gp)
        return [detect_dog_octave(dog, octave_params(p, dog))
                for dog in dg.octaves]

    def detect():
        gp = gaussian_pyramid(img, p.pyramid)
        return sum(det["x"].sum() + det["value"].sum()
                   for det in detections(gp))

    def orient():
        gp = gaussian_pyramid(img, p.pyramid)
        acc = 0.0
        for gauss, det in zip(gp.octaves, detections(gp)):
            gx, gy = gradient(gauss)
            theta, _ = dominant_orientations(
                gx, gy, det["x"], det["y"], det["s"], gp.sigmas,
                max_peaks=p.max_orientations)
            acc = acc + theta.sum()
        return acc

    def full():
        return compute_sift_keypoints(img, p, device=img.device)

    return dict(zip(STAGES, (pyramid, detect, orient, full)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features.api import SIFTParams
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    log("device:", dev)
    a, _b = load_pair()
    img = torch.as_tensor(a).to(dev)
    params = SIFTParams()

    results = {}
    for name, fn in stage_fns(img, params).items():
        _, dt, first = median_ms(fn, dev, ITERS)
        log(f"{name}: first call {first:.1f}s")
        results[name] = dt
        log(f"{name}: {dt:.1f} ms")

    prev = 0.0
    for name, dt in results.items():
        log(f"STAGE {name:8s} cum {dt:7.1f} ms  delta {dt - prev:7.1f} ms")
        prev = dt
    return results


if __name__ == "__main__":
    main()
