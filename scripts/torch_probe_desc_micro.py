"""Micro-timing of the descriptor and orientation-peak internals on the
PyTorch / CUDA port.

Twin of ``scripts/probe_desc_micro.py``. Its shapes are those of the
dominant first_octave = -1 octave: maps (3, 480, 640, 36) bfloat16, K =
3840 descriptor slots. It times exactly the probe's eight pieces, each
the median of 10 calls after a warm-up call (CUDA events after a
synchronize on the card, the host clock on the CPU):

- ``desc: 4 gathers``: the four bilinear corner row gathers of 16 samples
  per slot from the flat maps;
- ``desc: wfo build``: the 36 -> 8 orientation-bin weights per slot;
- ``desc: wfo+einsum``: the weights and their collapse of (K, 16, 36)
  samples;
- ``desc: gemm+shift``: one fixed GEMM with the theta = 0 weights, then a
  fractional circular shift of the 8 bins per slot;
- ``peaks: lowe_smooth``: 6 circular box-3 passes over (K, 36) histograms;
- ``peaks: find_peaks``: local maxima >= 0.8 x the global one, the top 2
  (``lax.top_k``'s order: a stable descending sort), parabola offsets;
- ``peaks: argmax-top2``: the same top 2 by two argmaxes;
- ``peaks: sample``: ``features/orientation.py::sample_orientation_maps``
  at one sample per slot.

:func:`functions` returns the eight functions over given maps, so they can
be held to the probe's on small inputs. It imports only
``sara_tpu_torch`` and numpy, and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_desc_micro.py [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

REPS = 10
SHAPE = dict(S=3, Hc=480, Wc=640, FB=36, K=3840)
NO = 8


def make_inputs(device, S, Hc, Wc, FB, K) -> dict:
    """The probe's inputs from ``RandomState(0)``, in its order: maps (S,
    Hc, Wc, FB) bfloat16, th (K,), xs, ys (K, 16), si (K,), F (K, 16, FB)
    and hist (K, FB) float32, on ``device``."""
    import torch

    rs = np.random.RandomState(0)

    def f32(a):
        return torch.as_tensor(a.astype(np.float32)).to(device)

    maps = f32(rs.rand(S, Hc, Wc, FB)).to(torch.bfloat16)
    th = f32(rs.uniform(-np.pi, np.pi, K))
    xs = f32(rs.uniform(0, Wc - 1, (K, 16)))
    ys = f32(rs.uniform(0, Hc - 1, (K, 16)))
    si = torch.as_tensor(rs.randint(0, S, K)).to(device)
    F = f32(rs.rand(K, 16, FB))
    hist = f32(rs.rand(K, FB))
    return dict(maps=maps, th=th, xs=xs, ys=ys, si=si, F=F, hist=hist)


def functions(maps) -> dict:
    """The probe's eight timed functions (name -> (function, the names of
    its inputs)), each reduced to a sum as the probe reduces it."""
    import torch

    from sara_tpu_torch.features.orientation import sample_orientation_maps

    S, Hc, Wc, FB = maps.shape
    dev = maps.device
    two_pi = 2 * math.pi

    def gathers(xs, ys, si):
        K = xs.shape[0]
        x0 = torch.floor(xs).long()
        y0 = torch.floor(ys).long()
        flat = maps.reshape(S * Hc * Wc, FB)
        base = si.long()[:, None] * (Hc * Wc)

        def take(yy, xx):
            lin = (base + yy * Wc + xx).reshape(-1)
            return flat.index_select(0, lin).reshape(K, -1, FB).float()

        x1 = torch.clamp(x0 + 1, max=Wc - 1)
        y1 = torch.clamp(y0 + 1, max=Hc - 1)
        f = take(y0, x0) + take(y0, x1) + take(y1, x0) + take(y1, x1)
        return torch.sum(f)

    def alpha():
        return ((torch.arange(FB, dtype=torch.float32, device=dev) + 0.5)
                * (two_pi / FB))

    def wfo(th):
        ob = (alpha()[None, :] - th[:, None]) / two_pi * NO
        o = torch.arange(NO, dtype=torch.float32, device=dev)
        d = torch.abs((ob[..., None] - o[None, None, :] + NO / 2) % NO
                      - NO / 2)
        return torch.clamp(1.0 - d, min=0.0)

    def wfo_build(th):
        return torch.sum(wfo(th))

    def einsum_collapse(F, th):
        return torch.sum(torch.einsum("knf,kfo->kno", F, wfo(th)))

    def fixed_gemm_shift(F, th):
        K = F.shape[0]
        o = torch.arange(NO, dtype=torch.float32, device=dev)
        d0 = torch.abs((alpha()[:, None] / two_pi * NO - o[None, :]
                        + NO / 2) % NO - NO / 2)
        W0 = torch.clamp(1.0 - d0, min=0.0)                    # (36, 8)
        C = (F.reshape(-1, FB) @ W0).reshape(K, 16, NO)
        sh = th / two_pi * NO
        i0 = torch.floor(sh).long()
        fr = (sh - i0)[:, None, None]
        idx0 = (torch.arange(NO, device=dev)[None, :] + i0[:, None]) % NO
        g0 = torch.gather(C, 2, idx0[:, None, :].expand(K, 16, NO))
        idx1 = (idx0 + 1) % NO
        g1 = torch.gather(C, 2, idx1[:, None, :].expand(K, 16, NO))
        return torch.sum(g0 * (1 - fr) + g1 * fr)

    def lowe(h):
        for _ in range(6):
            h = (torch.roll(h, 1, -1) + h + torch.roll(h, -1, -1)) / 3.0
        return torch.sum(h)

    def peak_scores(h):
        left = torch.roll(h, 1, -1)
        right = torch.roll(h, -1, -1)
        gmax = h.amax(-1, keepdim=True)
        is_peak = (h > left) & (h > right) & (h >= 0.8 * gmax) & (gmax > 0)
        return left, right, torch.where(is_peak, h, torch.full_like(h, -1.0))

    def peaks(h):
        left, right, score = peak_scores(h)
        vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :2], idx[:, :2]
        hl = torch.gather(left, -1, idx)
        hc = torch.gather(h, -1, idx)
        hr = torch.gather(right, -1, idx)
        den = hl - 2 * hc + hr
        off = torch.where(den.abs() > 1e-12, 0.5 * (hl - hr) / den,
                          torch.zeros_like(den))
        return torch.sum(idx + off) + torch.sum(vals)

    def argmax_peaks(h):
        K = h.shape[0]
        _, _, score = peak_scores(h)
        i1 = torch.argmax(score, -1)
        v1 = torch.gather(score, -1, i1[:, None])[:, 0]
        rows = torch.arange(K, device=dev)
        score2 = score.index_put((rows, i1), torch.full_like(v1, -1.0))
        i2 = torch.argmax(score2, -1)
        v2 = torch.gather(score2, -1, i2[:, None])[:, 0]
        return torch.sum(i1 + i2) + torch.sum(v1 + v2)

    def sample_hist(xs, ys, si):
        return torch.sum(sample_orientation_maps(
            maps, xs[:, 0] * 0 + xs[:, 0], ys[:, 0], si.float(),
            downsample=1))

    return {"desc: 4 gathers": (gathers, ("xs", "ys", "si")),
            "desc: wfo build": (wfo_build, ("th",)),
            "desc: wfo+einsum": (einsum_collapse, ("F", "th")),
            "desc: gemm+shift": (fixed_gemm_shift, ("F", "th")),
            "peaks: lowe_smooth": (lowe, ("hist",)),
            "peaks: find_peaks": (peaks, ("hist",)),
            "peaks: argmax-top2": (argmax_peaks, ("hist",)),
            "peaks: sample": (sample_hist, ("xs", "ys", "si"))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    inputs = make_inputs(dev, **SHAPE)
    results = {}
    for name, (fn, keys) in functions(inputs["maps"]).items():
        args_ = [inputs[k] for k in keys]
        _, dt, first = median_ms(lambda: fn(*args_), dev, REPS)
        print(f"{name:22s} {dt:7.2f} ms  (first call {first:.1f}s)",
              flush=True)
        results[name] = dt
    return results


if __name__ == "__main__":
    main()
