"""Segment-sum strategies for the BA block assembly on the PyTorch / CUDA
port.

Twin of ``scripts/probe_segsum.py``. Variants, each summing (O, k) float32
rows into their segments (``ba/core.py::_segment_sum`` is the first):
  scatter         - ``index_add_`` (the port's segment sum; the probe's
                    ``jax.ops.segment_sum``)
  scatter_sorted  - ``torch.segment_reduce`` over the sorted rows' segment
                    lengths (the probe: the same scatter with
                    ``indices_are_sorted=True``)
  cumsum          - sorted indices: a global cumsum and a boundary diff
  cumsum2         - two-level (within-block cumsum + block-offset cumsum)

Each on (O, 36) data summed into C = 256 segments (the U blocks) and
(O, 9) into P = 60k segments (the V blocks), timed as the median of 5
calls after a warm-up call (CUDA events after a synchronize on the card,
the host clock on the CPU), with its largest error relative to a float64
host reference, per segment over |segment| + mean |segment| as the probe
measures it: a global float32 cumsum over 1e8-scale prefixes loses 3-4
digits on small late segments, the scatters none. The largest error is
also given in float32 epsilons (2^-23) of the largest prefix sum: a
segment of a cumsum is the difference of two rounded prefixes, and a
float32 scan's rounding errors add up like a random walk, to about
sqrt(O) epsilons of the largest prefix (a CPU cumsum accumulates in
float64, the card's in float32).

It imports only torch and numpy, and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_segsum.py [--obs 800000] [--cams 256]
       [--points 60000] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

REPS = 5
VARIANTS = ("scatter", "scatter_sorted", "cumsum", "cumsum2")
BLOCK = 1024
EPS32 = 2.0 ** -23


def variants(idx, nseg):
    """The four strategies by name, each (data (O, k)) -> (nseg, k), for
    the sorted segment ids ``idx`` (O,) on their device."""
    import torch

    O = idx.shape[0]
    lengths = torch.bincount(idx.long(), minlength=nseg)
    starts = torch.cumsum(lengths, 0) - lengths
    ends = starts + lengths

    def scatter(d):
        return d.new_zeros((nseg, d.shape[1])).index_add_(0, idx.long(), d)

    def scatter_sorted(d):
        return torch.segment_reduce(d, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    def cumsum(d):
        c = torch.cat([d.new_zeros((1, d.shape[1])), torch.cumsum(d, 0)])
        return c[ends] - c[starts]

    nb = -(-O // BLOCK)
    pad_o = nb * BLOCK

    def cumsum2(d):
        dp = torch.nn.functional.pad(d, (0, 0, 0, pad_o - O))
        inner = torch.cumsum(dp.reshape(nb, BLOCK, d.shape[1]), 1)
        tot = inner[:, -1, :]
        off = torch.cumsum(tot, 0) - tot            # exclusive offsets
        flat = (inner + off[:, None, :]).reshape(pad_o, d.shape[1])
        c = torch.cat([d.new_zeros((1, d.shape[1])), flat])
        return c[ends] - c[starts]

    return dict(zip(VARIANTS, (scatter, scatter_sorted, cumsum, cumsum2)))


def rel_err(out, ref):
    """The probe's error: |out - ref| over |ref| + mean |ref|, the largest
    element."""
    seg_mag = np.abs(ref) + np.abs(ref).mean()
    return float((np.abs(out - ref) / seg_mag).max())


def prefix_eps(out, ref, data):
    """The largest |out - ref| in float32 epsilons of the largest |prefix
    sum| of ``data`` (O, k) along O."""
    top = np.abs(np.cumsum(data.astype(np.float64), axis=0)).max()
    return float(np.abs(out - ref).max() / (EPS32 * top))


def problem(rs, O, nseg, k):
    """The probe's sorted segment ids and (O, k) data (squared normals x
    300, float32), and their float64 host segment sums."""
    idx = np.sort(rs.randint(0, nseg, O)).astype(np.int32)
    data = (rs.normal(size=(O, k)) ** 2 * 300.0).astype(np.float32)
    ref = np.zeros((nseg, k))
    np.add.at(ref, idx, data.astype(np.float64))
    return idx, data, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--obs", type=int, default=800_000)
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=60_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    rs = np.random.RandomState(0)
    O = args.obs
    results = {}
    for label, nseg, k in (("U-blocks", args.cams, 36),
                           ("V-blocks", args.points, 9)):
        print(f"--- {label}: O={O} -> {nseg} segments, k={k}", flush=True)
        idx, data, ref = problem(rs, O, nseg, k)
        d = torch.as_tensor(data, device=dev)
        for name, fn in variants(torch.as_tensor(idx, device=dev),
                                 nseg).items():
            out, ms, first = median_ms(lambda fn=fn: fn(d), dev, REPS)
            out = out.double().cpu().numpy()
            err, eps = rel_err(out, ref), prefix_eps(out, ref, data)
            results[label, name] = {"ms": ms, "max_rel_err": err,
                                    "prefix_eps": eps, "rows": O}
            print(f"{name:18s} {ms:8.3f} ms  (first call {first:.1f}s)  "
                  f"max-rel-err {err:.2e}  ({eps:.2f} eps of the largest "
                  f"prefix)", flush=True)
    return results


if __name__ == "__main__":
    main()
