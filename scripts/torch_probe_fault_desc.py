"""The descriptor stage of the first_octave = -1 SIFT program at capacity
3072 (K2 = 3840 slots in the largest octave), piece by piece, on the
PyTorch / CUDA port.

Twin of ``scripts/probe_fault_desc.py``. The probe sub-bisected a TPU
worker fault in the descriptor stage; on the card every piece must simply
run. Every octave runs detection, orientation and the compaction of
``scripts/torch_probe_fault_bisect.py::octave_slots``, then one stage,
reduced to ``acc``:

  gather  the four bilinear corner gathers of the 16 bin centres per slot
          (multi-axis indexing of the maps), weighted: their sum
  einsum  the 36 -> 8 collapse einsum of synthetic samples (each slot
          reads the maps' channel sums)
  full    ``sift_descriptors_field`` of all K2 slots: sum + count
  chunk   the same descriptors in sections of <= 1920 slots, concatenated

Each prints ``<stage> OK: acc=...`` and its seconds. Where both ``full``
and ``chunk`` run, their descriptors are compared and the largest absolute
difference is printed (``full vs chunk: max abs diff``); they must agree.
The maps are float32 at stride 1 and the descriptors read them by row
gathers, as ``torch_probe_fault_bisect.py``'s. The stage argument takes one
stage, a comma list or "all".

The frame is ``torch_bench.probe_frames``' first, printed. It imports only
``sara_tpu_torch``, numpy, ``torch_bench`` and the twin above, and runs on
the card unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_fault_desc.py [stage] [--hw 480x640]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

STAGES = ("gather", "einsum", "full", "chunk")
CH = 1920


def stage_outputs(image, stages, p) -> dict:
    """Per stage its acc, and for "full" and "chunk" the descriptors of
    every octave (``desc_full``, ``desc_chunk``), over the octaves of
    ``image``'s pyramid."""
    import torch

    from sara_tpu_torch.features.sift import (BIN_SCALE_UNIT, N_ORI,
                                              N_SPATIAL,
                                              sift_descriptors_field)
    from sara_tpu_torch.image.pyramid import dog_pyramid, gaussian_pyramid
    from torch_probe_fault_bisect import octave_slots

    gp = gaussian_pyramid(image, p.pyramid)
    dg = dog_pyramid(gp)
    sigmas = gp.sigmas[:-1]
    out = {s: 0.0 for s in stages}
    descs = {"full": [], "chunk": []}
    for o in octave_slots(gp, dg, p, "compact"):
        maps = o["maps"]
        x, y, s, th, mask = (o[k] for k in ("x", "y", "s", "th", "mask"))
        K2 = x.shape[0]
        S, Hc, Wc, FB = maps.shape
        dev = maps.device
        s_idx = torch.clamp(torch.round(s).long(), 0, S - 1)
        sig_table = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
        l = BIN_SCALE_UNIT * sig_table[s_idx]
        u = (torch.arange(N_SPATIAL, dtype=torch.float32, device=dev)
             - (N_SPATIAL - 1) / 2.0)
        uu, vv = torch.meshgrid(u, u, indexing="xy")
        ct, st = torch.cos(th), torch.sin(th)
        dx = (ct[:, None, None] * uu - st[:, None, None] * vv) \
            * l[:, None, None]
        dy = (st[:, None, None] * uu + ct[:, None, None] * vv) \
            * l[:, None, None]
        xs = (x[:, None, None] + dx).reshape(K2, -1)
        ys = (y[:, None, None] + dy).reshape(K2, -1)
        xc = xs.clamp(0.0, Wc - 1.0)
        yc = ys.clamp(0.0, Hc - 1.0)
        x0 = torch.floor(xc).long()
        y0 = torch.floor(yc).long()
        x1 = torch.clamp(x0 + 1, max=Wc - 1)
        y1 = torch.clamp(y0 + 1, max=Hc - 1)
        fx = (xc - x0)[..., None].float()
        fy = (yc - y0)[..., None].float()
        si = s_idx[:, None]
        for stage in stages:
            if stage == "gather":
                F = (maps[si, y0, x0].float() * (1 - fx) * (1 - fy)
                     + maps[si, y0, x1].float() * fx * (1 - fy)
                     + maps[si, y1, x0].float() * (1 - fx) * fy
                     + maps[si, y1, x1].float() * fx * fy)
                out[stage] = out[stage] + F.sum()
            elif stage == "einsum":
                F = maps.float().sum(dim=(0, 1, 2))[None, None, :].expand(
                    K2, 16, FB)
                alpha = ((torch.arange(FB, dtype=torch.float32, device=dev)
                          + 0.5) * (2 * math.pi / FB))
                ob = (alpha[None, :] - th[:, None]) / (2 * math.pi) * N_ORI
                oo = torch.arange(N_ORI, dtype=torch.float32, device=dev)
                d = torch.abs((ob[..., None] - oo[None, None, :] + N_ORI / 2)
                              % N_ORI - N_ORI / 2)
                wfo = torch.clamp(1.0 - d, min=0.0)
                out[stage] = out[stage] + torch.einsum(
                    "knf,kfo->kno", F, wfo).sum()
            else:
                sections = ([(0, K2)] if stage == "full" else
                            [(c0, min(c0 + CH, K2))
                             for c0 in range(0, K2, CH)])
                desc = torch.cat([sift_descriptors_field(
                    maps, x[c0:c1], y[c0:c1], s[c0:c1], th[c0:c1], sigmas,
                    downsample=1, sampler="gather")
                    for c0, c1 in sections])
                descs[stage].append(desc)
                out[stage] = out[stage] + desc.sum() + mask.sum()
    out = {k: float(v) for k, v in out.items()}
    for k, v in descs.items():
        if v:
            out[f"desc_{k}"] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", nargs="?", default="gather",
                    help="one of " + ", ".join(STAGES) + ", a comma list "
                    "or all")
    ap.add_argument("--hw", default="480x640")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import torch_bench
    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.features.api import SIFTParams
    from sara_tpu_torch.features.dog import DoGParams
    from torch_probe_fault_bisect import parse_stages

    stages = parse_stages(args.stage, STAGES)
    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    (img,), source = torch_bench.probe_frames(1, h, w)
    print("device:", dev, "stage:", args.stage, "input:", source, flush=True)
    a = torch.as_tensor(img).to(dev)
    params = SIFTParams(dog=DoGParams(capacity=3072))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res = {}
    for stage in stages:
        t0 = time.perf_counter()
        out = stage_outputs(a, [stage], params)
        sync()
        print(f"{stage} OK: acc={out[stage]:.3f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        res[stage] = out[stage]
        if stage in ("full", "chunk"):
            res[f"desc_{stage}"] = out[f"desc_{stage}"]
    if "desc_full" in res and "desc_chunk" in res:
        res["full_vs_chunk"] = max(
            float((f - c).abs().max()) if f.numel() else 0.0
            for f, c in zip(res.pop("desc_full"), res.pop("desc_chunk")))
        print(f"full vs chunk: max abs diff {res['full_vs_chunk']:.3g}",
              flush=True)
    res.pop("desc_full", None)
    res.pop("desc_chunk", None)
    return res


if __name__ == "__main__":
    main()
