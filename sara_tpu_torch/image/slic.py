"""SLIC superpixel segmentation.

Twin of ``sara_tpu/image/slic.py`` (reference:
cpp/src/DO/Shakti/Cuda/Segmentation/SuperPixel.cu): a dense fixed-iteration
program in which every pixel evaluates the 9 candidate clusters of its grid
neighbourhood.

- The assignment keeps the twin's candidate order, ``(dy, dx)`` over
  ``(-1, 0, 1)`` squared, and its strict ``d < best_d``: at a tie the first
  candidate stays.
- The cluster update's ``jax.ops.segment_sum`` becomes one ``index_add_``
  of each pixel's (y, x, 1, colour) in float64, rounded to float32 once
  per sum; no host read. The twin sums in float32. In float64 these sums
  are exact (integer coordinates and counts; a few hundred float32
  colours), so the
  card's atomics, in whatever order, give the CPU's centres bit for bit:
  float32 atomics made 27 of 307,200 labels and the centres (by 0.196 px)
  differ between card and CPU at 480x640 (NVIDIA H100 80GB HBM3, 700.00 W,
  ``chip_smoke.py`` phase "e3"). The positions equal the twin's wherever
  its float32 sums are exact; the colours differ from its sequential
  float32 sums by a few ulps (the centres by < 1e-6, no label moved on the
  parity test's images or on the 480x640 frame).

Each function runs where its input tensor lies; a host array goes to the
card.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.utils.host import as_tensor


def slic(image, grid: int = 16, iters: int = 10, compactness: float = 0.1):
    """Segment a (H, W) or (H, W, C) float image into ~(H/grid)*(W/grid)
    superpixels.

    Returns (labels (H, W) int32, centers (Gy, Gx, 2+C)).
    """
    image = as_tensor(image)
    img = image[..., None] if image.dim() == 2 else image
    H, W, C = img.shape
    dev = img.device
    Gy = max(H // grid, 1)
    Gx = max(W // grid, 1)
    f32 = dict(dtype=torch.float32, device=dev)

    ys = (torch.arange(Gy, **f32) + 0.5) * (H / Gy)
    xs = (torch.arange(Gx, **f32) + 0.5) * (W / Gx)
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    yi = cy.to(torch.int32).clamp(0, H - 1).long()
    xi = cx.to(torch.int32).clamp(0, W - 1).long()
    centers_pos = torch.stack([cy, cx], -1)              # (Gy, Gx, 2)
    centers_col = img[yi, xi]                            # (Gy, Gx, C)

    py, px = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32),
                            indexing="ij")
    # Spatial scale: normalize pixel distance by the grid step.
    inv_s2 = (compactness / grid) ** 2
    # Each pixel's home grid cell.
    gy = (py / (H / Gy)).to(torch.int32).clamp(0, Gy - 1)
    gx = (px / (W / Gx)).to(torch.int32).clamp(0, Gx - 1)
    # The 9 candidate labels of each pixel, in the twin's (dy, dx) order.
    cands = [(gy + dy).clamp(0, Gy - 1) * Gx + (gx + dx).clamp(0, Gx - 1)
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    cands = [(lbl, lbl.long()) for lbl in cands]

    def assign(centers_pos, centers_col):
        best_d = torch.full((H, W), float("inf"), **f32)
        best_l = torch.zeros((H, W), dtype=torch.int32, device=dev)
        for lbl, at in cands:
            cpos = centers_pos.reshape(-1, 2)[at]             # (H, W, 2)
            ccol = centers_col.reshape(-1, C)[at]             # (H, W, C)
            d_sp = ((py - cpos[..., 0]) ** 2 + (px - cpos[..., 1]) ** 2)
            d_col = ((img - ccol) ** 2).sum(-1)
            d = d_col + inv_s2 * d_sp
            upd = d < best_d
            best_d = torch.where(upd, d, best_d)
            best_l = torch.where(upd, lbl, best_l)
        return best_l

    n = Gy * Gx
    # Each pixel's (y, x, 1, colour) row, summed per cluster in float64.
    rows = torch.cat([py[..., None], px[..., None], torch.ones_like(py)[
        ..., None], img], -1).reshape(H * W, 3 + C).to(torch.float64)

    def update(labels):
        sums = torch.zeros(n, 3 + C, dtype=torch.float64,
                           device=dev).index_add_(0, labels.reshape(-1).long(),
                                                  rows).to(torch.float32)
        cnt = sums[:, 2:3].clamp_min(1.0)
        return ((sums[:, :2] / cnt).reshape(Gy, Gx, 2),
                (sums[:, 3:] / cnt).reshape(Gy, Gx, C))

    for _ in range(iters):
        centers_pos, centers_col = update(assign(centers_pos, centers_col))
    labels = assign(centers_pos, centers_col)
    centers = torch.cat([centers_pos, centers_col], -1)
    return labels, centers
