"""Growing prefixes of the first_octave = -1 SIFT program at capacity 3072,
on the PyTorch / CUDA port.

Twin of ``scripts/probe_fault_bisect.py``. The probe bisected a TPU worker
fault by running each prefix in its own process; on the card the same
prefixes must simply run, so one process may run them all. Each prefix
goes through every octave of the pyramid of ``SIFTParams(dog=DoGParams(
capacity=CAP))`` (each octave's capacity min(CAP, max(64, S H W / 512)))
and is reduced to one number, ``acc``:

  detect   ``detect_dog_octave``: sum of x + the count of kept slots
  orient   ``orientation_maps`` of the gradients: the maps' sum
  peaks    bilinear histogram samples, ``lowe_smooth``,
           ``find_orientation_peaks``: sum of the angles + valid count
  compact  the (K + K/4) slots of valid orientations, in order: sum of x
           + count
  desc     ``sift_descriptors_field`` (bilinear) on them: the descriptors'
           sum + count
  merge    the whole ``compute_sift_keypoints``: its keypoint count

Each prints ``<stage> OK: acc=...`` (``merge OK: <n> kp``) and its
seconds. The maps are float32 at stride 1 and the descriptors read them
by row gathers ("gather"): the probe's program on any backend but a TPU,
where it took bfloat16 maps at stride 2 and the Pallas sampler. The
stage argument takes one stage, a comma list or "all".

The frame is ``torch_bench.probe_frames``' first (the reference's
photograph, else a render of ``make_room(seed=1)``), printed. It imports
only ``sara_tpu_torch``, numpy and ``torch_bench``, and runs on the card
unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_fault_bisect.py [stage] [cap]
       [--hw 480x640] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STAGES = ("detect", "orient", "peaks", "compact", "desc", "merge")


def parse_stages(arg: str, names) -> list:
    """"all", one name or a comma list of ``names``."""
    stages = list(names) if arg == "all" else arg.split(",")
    unknown = [s for s in stages if s not in names]
    if unknown:
        raise ValueError(f"unknown stages {unknown}; stages: {names}")
    return stages


def octave_slots(gp, dg, p, stop: str):
    """For each octave of the pyramids ``gp``, ``dg``: the detector's
    output (``det``) and, past "detect", the orientation maps (``maps``),
    past "orient" the angles (``theta``, ``tvalid``), past "peaks" the
    compacted slots (``x``, ``y``, ``s``, ``th``, ``mask``), as a dict."""
    import torch

    from sara_tpu_torch.features.dog import detect_dog_octave
    from sara_tpu_torch.features.orientation import (find_orientation_peaks,
                                                     lowe_smooth,
                                                     orientation_maps,
                                                     sample_orientation_maps)
    from sara_tpu_torch.image.differential import gradient

    for gauss, dog in zip(gp.octaves, dg.octaves):
        s_, h_, w_ = dog.shape
        cap = min(p.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        det = detect_dog_octave(dog, dataclasses.replace(p.dog, capacity=cap))
        out = {"det": det}
        if stop == "detect":
            yield out
            continue
        gx, gy = gradient(gauss[:-1])
        out["maps"] = orientation_maps(gx, gy, gp.sigmas[:-1], downsample=1)
        if stop == "orient":
            yield out
            continue
        hist = lowe_smooth(sample_orientation_maps(
            out["maps"], det["x"], det["y"], det["s"], downsample=1))
        out["theta"], out["tvalid"] = find_orientation_peaks(
            hist, max_peaks=p.max_orientations)
        if stop == "peaks":
            yield out
            continue
        K = det["x"].shape[0]
        P = p.max_orientations
        x, y, s, mask = (det[k].repeat_interleave(P)
                         for k in ("x", "y", "s", "mask"))
        mask = mask & out["tvalid"].reshape(-1)
        th = out["theta"].reshape(-1)
        K2 = K + K // 4
        order = torch.argsort((~mask).to(torch.int32), stable=True)[:K2]
        out.update(zip(("x", "y", "s", "th", "mask"),
                       (t[order] for t in (x, y, s, th, mask))))
        yield out


def prog(image, stage: str, p):
    """The probe's ``prog``: the prefix up to ``stage`` reduced to acc."""
    from sara_tpu_torch.features.sift import sift_descriptors_field
    from sara_tpu_torch.image.pyramid import dog_pyramid, gaussian_pyramid

    gp = gaussian_pyramid(image, p.pyramid)
    dg = dog_pyramid(gp)
    acc = 0.0
    stop = "compact" if stage == "desc" else stage
    for o in octave_slots(gp, dg, p, stop):
        det = o["det"]
        if stage == "detect":
            acc = acc + det["x"].sum() + det["mask"].sum()
        elif stage == "orient":
            acc = acc + o["maps"].float().sum()
        elif stage == "peaks":
            acc = acc + o["theta"].sum() + o["tvalid"].sum()
        elif stage == "compact":
            acc = acc + o["x"].sum() + o["mask"].sum()
        else:
            desc = sift_descriptors_field(
                o["maps"], o["x"], o["y"], o["s"], o["th"], gp.sigmas[:-1],
                downsample=1, sampler="gather")
            acc = acc + desc.float().sum() + o["mask"].sum()
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", nargs="?", default="detect",
                    help="one of " + ", ".join(STAGES) + ", a comma list "
                    "or all")
    ap.add_argument("cap", nargs="?", type=int, default=3072)
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import torch_bench
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.features.api import SIFTParams
    from sara_tpu_torch.features.dog import DoGParams

    stages = parse_stages(args.stage, STAGES)
    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    (img,), source = torch_bench.probe_frames(1, h, w)
    print("device:", dev, "stage:", args.stage, "cap:", args.cap, "input:",
          source, flush=True)
    a = torch.as_tensor(img).to(dev)
    params = SIFTParams(dog=DoGParams(capacity=args.cap))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for stage in stages:
        t0 = time.perf_counter()
        if stage == "merge":
            n = int(compute_sift_keypoints(a, params, device=dev).count())
            print(f"merge OK: {n} kp ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
            out[stage] = n
            continue
        acc = float(prog(a, stage, params))
        sync()
        print(f"{stage} OK: acc={acc:.3f} ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        out[stage] = acc
    return out


if __name__ == "__main__":
    main()
