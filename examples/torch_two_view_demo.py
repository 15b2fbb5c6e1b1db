"""Two-view demo (BASELINE config 1) on the PyTorch / CUDA port: SIFT
detect + match + RANSAC homography on an image pair.

Twin of ``examples/two_view_demo.py`` (reference:
cpp/examples/Sara/MultiViewGeometry/homography_estimation_example.cpp,
FeatureMatching examples). It imports only ``sara_tpu_torch`` and runs on
the card unless ``--cpu`` is given; without a card it raises. Where the JAX
demo reads the reference project's bundled photographs, the twin runs on
the synthetic pair (``sara_tpu_torch.io.datasets.synthetic_image_pair``:
uniform noise, B is A rolled 16 px along x) at ``--width``, where every
true match lies on the shift.

Usage: python examples/torch_two_view_demo.py [--out out_dir] [--width 640]
                                              [--cpu]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sara_tpu_torch_two_view"))
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features import compute_sift_keypoints
    from sara_tpu_torch.io.datasets import synthetic_image_pair
    from sara_tpu_torch.matching import MatchParams, match_descriptors
    from sara_tpu_torch.ransac import estimate_homography
    from sara_tpu_torch.viz import draw_keypoints, draw_matches

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    a, b = synthetic_image_pair(args.width)
    print(f"images: {a.shape} / {b.shape}")

    t0 = time.perf_counter()
    ka = compute_sift_keypoints(a, device=dev)
    kb = compute_sift_keypoints(b, device=dev)
    print(f"keypoints: {int(ka.count())} / {int(kb.count())} "
          f"({time.perf_counter()-t0:.1f}s, first call)")

    m = match_descriptors(ka, kb, MatchParams(ratio=0.8), device=dev)
    print(f"matches: {int(m.count())}")

    u = ka.xy
    v = kb.xy[m.j.long()]
    res = estimate_homography(torch.Generator(device=dev).manual_seed(0), u,
                              v, m.mask, threshold=4.0, num_samples=1000)
    print(f"homography inliers: {int(res.num_inliers)} "
          f"(success={bool(res.success)})")

    try:
        draw_keypoints(a, ka, os.path.join(args.out, "keypoints_a.png"))
        draw_keypoints(b, kb, os.path.join(args.out, "keypoints_b.png"))
        draw_matches(a, b, ka, kb, m, os.path.join(args.out, "matches.png"))
        print(f"wrote visualizations to {args.out}")
    except ImportError as e:               # no matplotlib on this machine
        print(f"(visualization skipped: {e})")
    return dict(images=(a, b), ka=ka, kb=kb, matches=m, ransac=res)


if __name__ == "__main__":
    main()
