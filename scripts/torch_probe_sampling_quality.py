"""Match quality of the four sampling configurations on the stride-2
orientation maps, on the PyTorch / CUDA port.

Twin of ``scripts/probe_sampling_quality.py``. The port's SIFT at
``SIFTParams(orientation_downsample=2)`` (first_octave -1, capacities
4096 / 8192, 2 refinements, the "gather" sampler) under each of nearest
or bilinear histogram sampling x nearest or bilinear descriptor sampling,
and its matcher (ratio 0.8), on a frame and its warp by the quality
tool's similarity homography, scored by the quality tool's twin
(``scripts/torch_eval_detection_quality.py``) against OpenCV's SIFT.

The frame is ``torch_bench.probe_frames(1)``: the reference's photograph
(sunflowerField.jpg) where it exists, else a render of
``make_room(seed=1)``; the source is printed. The warp and the OpenCV
baseline are ``torch_probe_dog_quality.warp_pair``'s: cv2 where it is
installed, else ``torch_bench.warp_without_cv2`` on the device with a
null baseline and null ratios.

Prints the probe's lines and returns one dict per configuration. It
imports only ``sara_tpu_torch``, numpy, ``torch_bench`` and the twins of
the quality tool and of ``probe_dog_quality``, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_sampling_quality.py [--hw 480x640]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def run_with(img_a, img_b, ds, desc_nearest, hist_nearest, sampler="gather",
             cap=8192, device=None):
    """The probe's configuration: ``SIFTParams(orientation_downsample=ds)``
    with the two nearest-sampling knobs and ``sampler``; a ``cap`` other
    than the default total capacity (8192) sets the total to ``cap`` and
    each octave's to ``cap // 2``. Returns ``match_sets``' (xy_a, xy_b,
    pairs)."""
    from sara_tpu_torch.features import SIFTParams

    from torch_probe_dog_quality import match_sets

    p = dataclasses.replace(SIFTParams(orientation_downsample=ds),
                            hist_sample_nearest=hist_nearest,
                            desc_sample_nearest=desc_nearest,
                            desc_sampler=sampler)
    if cap != p.total_capacity:
        p = dataclasses.replace(p, total_capacity=cap,
                                dog=dataclasses.replace(p.dog,
                                                        capacity=cap // 2))
    return match_sets(img_a, img_b, p, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch_bench
    from sara_tpu_torch import resolve_device

    from torch_probe_dog_quality import have_cv2, warp_pair

    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    (img,), source = torch_bench.probe_frames(1, h, w)
    print("device:", dev, "input:", source, "warp:",
          "cv2" if have_cv2() else "warp_homography on the device (zeros "
          "at the border; no cv2, no OpenCV baseline)", flush=True)
    q = torch_bench.quality_tool()
    warped, H, cv = warp_pair(q, img, dev)
    cv = cv or {"kp": None, "correct": None}
    cor_cv = cv["correct"]
    print(f"opencv: kp {cv['kp']} correct {cor_cv}".replace("None", "null"),
          flush=True)

    rows = []
    for hist_n in (False, True):
        for desc_n in (False, True):
            xy_a, xy_b, pairs = run_with(img, warped, 2, desc_n, hist_n,
                                         device=dev)
            cor, n = q.match_quality(xy_a, xy_b, pairs, H)
            rep, _ = q.repeatability(xy_a, xy_b, H, h, w)
            ratio = None if cor_cv is None else cor / max(cor_cv, 1)
            rows.append({"hist_nearest": hist_n, "desc_nearest": desc_n,
                         "kp": [len(xy_a), len(xy_b)], "matches": n,
                         "correct": cor, "ratio_vs_cv": ratio,
                         "repeatability": rep})
            print(f"hist_nearest={hist_n!s:5} desc_nearest={desc_n!s:5} "
                  f"kp {len(xy_a)} correct {cor} "
                  f"({'null' if ratio is None else f'{ratio:.3f}'}x) "
                  f"rep {rep:.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
