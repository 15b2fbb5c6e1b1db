"""The cost of ``compute_tracks`` against the sequence length, on the
PyTorch / CUDA port's tracker.

Twin of ``scripts/probe_tracker_flat.py``. This probe times host code:
``sfm/tracker.py::FeatureTracker`` is NumPy with the native union-find of
``sfm/disjoint_sets.py`` (compiled from the port's copy of the reference's
``sara_native.cpp``); nothing of it runs on the card. A VO-like run adds
``cap`` features per frame and cap / 4 random matches to the previous
frame, and times ``compute_tracks`` at every frame: (a) through the native
incremental core, then (b) through the NumPy batch path
(``_compute_tracks_batch``, ``--batch-frames`` frames). It prints the ms of
one call at the checkpoints 1/8, 1/4, 1/2 and 3/4 of the run and its last
frame, and the incremental path's growth from the first checkpoint to the
last (flat means ~1x).

It imports only ``sara_tpu_torch`` and numpy. It takes ``--device`` as the
other twins do and, without ``--device cpu``, needs a card (it raises
without one) although the tracker stays on the host.

Usage: python scripts/torch_probe_tracker_flat.py [--frames 500]
       [--cap 4096] [--batch-frames 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def run(frames, cap, use_native, tracker=None):
    """(ms of ``compute_tracks`` at each checkpoint, the tracker) after
    ``frames`` frames of ``cap`` features (``RandomState(0)``'s responses
    and matches); ``tracker`` defaults to a new ``FeatureTracker``."""
    from sara_tpu_torch.sfm.tracker import FeatureTracker

    rs = np.random.RandomState(0)
    tr = FeatureTracker() if tracker is None else tracker
    marks = {}
    checkpoints = sorted({frames // 8, frames // 4, frames // 2,
                          3 * frames // 4, frames - 1})
    for f in range(frames):
        tr.add_frame(cap, rs.random(cap).astype(np.float32))
        if f:
            m = cap // 4
            tr.add_matches(f - 1, f, rs.randint(0, cap, m),
                           rs.randint(0, cap, m))
        t0 = time.perf_counter()
        if use_native:
            tr.compute_tracks(2)
        else:
            tr._compute_tracks_batch(2)
        dt = (time.perf_counter() - t0) * 1e3
        if f in checkpoints:
            marks[f] = dt
    return marks, tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--cap", type=int, default=4096)
    ap.add_argument("--batch-frames", type=int, default=200,
                    help="frame budget for the (slow) batch-path comparison")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.sfm import disjoint_sets

    resolve_device(args.device)
    print("union-find backend:", disjoint_sets.backend(), flush=True)
    inc, _ = run(args.frames, args.cap, use_native=True)
    print("incremental (native core), ms per compute_tracks call:")
    for f, ms in sorted(inc.items()):
        print(f"  frame {f:4d}: {ms:7.1f} ms")
    first, last = min(inc), max(inc)
    growth = inc[last] / max(inc[first], 1e-9)
    print(f"  growth frame {first}->{last}: {growth:.2f}x", flush=True)

    bat, _ = run(args.batch_frames, args.cap, use_native=False)
    print(f"batch path (to {args.batch_frames} frames), ms per call:")
    for f, ms in sorted(bat.items()):
        print(f"  frame {f:4d}: {ms:7.1f} ms")
    sys.stdout.flush()
    return {"incremental": inc, "growth": growth, "batch": bat,
            "backend": disjoint_sets.backend()}


if __name__ == "__main__":
    main()
