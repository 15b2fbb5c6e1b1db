"""Edge detection: Canny-style NMS + hysteresis, Hough lines, segments.

Twin of ``sara_tpu/image/edges.py``. Each function runs where its input
tensor lies; a host array goes to the card (``resolve_device(None)``).

- The orientation-quantized NMS compares each pixel with its two
  neighbours along the gradient through clamped (border-replicating)
  shifts, never a wrapped roll.
- Hysteresis is the twin's fixed count of 3x3 dilations of the strong
  seeds restricted to the weak mask (a max-pool of the 0/1 map, exact).
- The Hough accumulator is a scatter-add with ``accumulate=True``: many
  edgels land in one (theta, rho) bin and every vote counts. The votes
  are 0/1, so the sums are exact in any order. Its thetas, bins and
  top K round and order as the jitted twin's do (``hough_lines``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch import resolve_device
from sara_tpu_torch.image.differential import _shift, gradient
from sara_tpu_torch.image.filtering import gaussian_blur
from sara_tpu_torch.utils.host import put


def _as_image(image) -> torch.Tensor:
    """A tensor stays where it is; a host array goes to the card."""
    if isinstance(image, torch.Tensor):
        return image
    return put(np.asarray(image, np.float32), resolve_device(None))


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation; outside the image counts as False."""
    m = F.max_pool2d(mask[None, None].to(torch.float32), 3, stride=1,
                     padding=1)
    return m[0, 0] > 0


def canny(image, low: float = 0.05, high: float = 0.15, sigma: float = 1.4,
          hysteresis_iters: int = 32) -> torch.Tensor:
    """Canny edge map of a (H, W) float image. Returns bool (H, W)."""
    image = _as_image(image)
    sm = gaussian_blur(image, sigma)
    gx, gy = gradient(sm)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)

    # Quantize orientation into 4 NMS directions.
    a = torch.remainder(ang, math.pi)
    bins = torch.remainder(
        torch.floor((a + math.pi / 8) / (math.pi / 4)).to(torch.int32), 4)
    # (dy, dx) of the neighbour pair per bin: horizontal gradient, diag /,
    # vertical, diag \.
    na = torch.empty_like(mag)
    nb = torch.empty_like(mag)
    for k, (dy, dx) in enumerate(((0, 1), (1, 1), (1, 0), (1, -1))):
        sel = bins == k
        na = torch.where(sel, _shift(mag, dy, dx), na)
        nb = torch.where(sel, _shift(mag, -dy, -dx), nb)
    is_max = (mag >= na) & (mag >= nb)

    strong = is_max & (mag >= high)
    weak = is_max & (mag >= low)
    edges = strong
    for _ in range(hysteresis_iters):
        edges = _dilate3(edges) & weak
    return edges


def hough_lines(edge_map, num_thetas: int = 180, num_rhos: int = 400,
                max_lines: int = 32):
    """Top-K lines (rho, theta) from an edge map by dense Hough voting.

    Returns (rho (K,), theta (K,), votes (K,)), the twin's lines in the
    twin's order: each value rounds as ``jax.jit`` of the twin computes it
    on the CPU, so the card and the CPU return the same lines.
    - The thetas are ``iota * float32(pi / num_thetas)``, the constant XLA
      folds ``jnp.linspace(0, pi, num_thetas, endpoint=False)`` into; their
      cosines and sines are taken in float64 and rounded once.
    - ``x cos + y sin`` is one fused multiply-add, ``fma(x, cos, y sin)``,
      as XLA's CPU code contracts it (emulated in float64, where the
      product is exact); the bin is ``(rho + diag)`` times the folded
      constant ``float32(float32(1 / (2 diag)) * num_rhos)``.
    - The votes are integers, so the accumulator is exact in any order.
    - The top K is a stable descending sort: equal votes come lowest index
      first, as ``lax.top_k`` returns them (``torch.topk`` orders ties
      arbitrarily, and Hough votes tie often).
    """
    edge_map = _as_image(edge_map)
    dev = edge_map.device
    H, W = edge_map.shape
    f32 = np.float32
    diag = f32(np.sqrt(f32(H * H + W * W)))
    thetas = np.arange(num_thetas, dtype=f32) * f32(f32(np.pi)
                                                    * f32(1.0 / num_thetas))
    ct, st = (put(fn(thetas.astype(np.float64)).astype(f32), dev)
              for fn in (np.cos, np.sin))
    pts = edge_map.reshape(-1).to(torch.float32)
    y, x = (g.reshape(-1).to(torch.float32) for g in torch.meshgrid(
        torch.arange(H, device=dev), torch.arange(W, device=dev),
        indexing="ij"))
    rho = (x.double()[:, None] * ct.double()[None, :]
           + (y[:, None] * st[None, :]).double()).to(torch.float32)  # (N, T)
    scale = float(f32(f32(f32(1.0) / (f32(2.0) * diag)) * f32(num_rhos)))
    rbin = torch.clamp((rho + float(diag)) * scale, 0,
                       num_rhos - 1).to(torch.int64)
    tbin = torch.arange(num_thetas, device=dev)[None, :].expand_as(rbin)
    acc = torch.zeros((num_thetas, num_rhos), dtype=torch.float32,
                      device=dev)
    acc.index_put_((tbin.reshape(-1), rbin.reshape(-1)),
                   pts.repeat_interleave(num_thetas), accumulate=True)
    # 3x3 non-max suppression on the accumulator (zero outside).
    accp = F.pad(acc, (1, 1, 1, 1))
    neigh = torch.stack([accp[1 + dy: 1 + dy + num_thetas,
                              1 + dx: 1 + dx + num_rhos]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if not (dy == 0 and dx == 0)]).amax(0)
    score = torch.where(acc >= neigh, acc, torch.zeros_like(acc)).reshape(-1)
    idx = torch.sort(score, descending=True, stable=True).indices[:max_lines]
    t_idx = idx // num_rhos
    r_idx = idx % num_rhos
    # (r + 0.5) / num_rhos * 2 diag - diag, folded and fused as XLA does.
    step = float(f32(f32(f32(1.0) / f32(num_rhos)) * f32(2.0)) * diag)
    rho_out = ((r_idx.to(torch.float32) + 0.5).double() * step
               - float(diag)).to(torch.float32)
    return rho_out, put(thetas, dev)[t_idx], score[idx]


def line_segment_endpoints(edge_map, rho, theta, votes, max_lines: int = 32,
                           band: float = 2.0):
    """Segment endpoints for Hough lines: project edge pixels within a band
    of each line onto its direction and take masked min/max. Returns
    (p0 (K, 2), p1 (K, 2), ok (K,)); a line without edge pixels gives NaN
    endpoints and ok False."""
    e = _as_image(edge_map)
    dev = e.device
    H, W = e.shape
    y, x = (g.to(torch.float32) for g in torch.meshgrid(
        torch.arange(H, device=dev), torch.arange(W, device=dev),
        indexing="ij"))
    r = rho[:, None, None]
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    on = e[None] & (torch.abs(x * ct + y * st - r) < band)      # (K, H, W)
    s = -x * st + y * ct                       # along the line (-st, ct)
    inf = torch.tensor(float("inf"), device=dev)
    smin = torch.where(on, s, inf).flatten(1).amin(1)
    smax = torch.where(on, s, -inf).flatten(1).amax(1)
    any_on = on.flatten(1).any(1)
    nan = torch.full_like(smin, float("nan"))
    smin = torch.where(any_on, smin, nan)
    smax = torch.where(any_on, smax, nan)
    r, ct, st = rho, torch.cos(theta), torch.sin(theta)
    p0 = torch.stack([r * ct - smin * st, r * st + smin * ct], dim=-1)
    p1 = torch.stack([r * ct - smax * st, r * st + smax * ct], dim=-1)
    return p0, p1, (votes > 0) & any_on
