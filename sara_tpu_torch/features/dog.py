"""DoG scale-space extrema: detection, refinement, edge rejection.

Twin of ``sara_tpu/features/dog.py``: 26-neighbour non-max suppression as
one stencil over the (S+2, H, W) DoG stack, a fixed-capacity top-k
compaction, and Newton refinement with integer re-centring that reads one
row of a dense derivative field per keypoint and iteration. The reference's
``fori_loop`` is a Python loop here. Every function takes leading dims
before the stack (the frames of a batch, ``(B, S+2, H, W)``) and treats
each frame as the reference's ``vmap`` does: the top-k runs per frame, and
the refinement reads the frame-folded field at ``b·S·H·W + s·H·W + y·W +
x``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from sara_tpu_torch.ops.topk import bucketed_top_k


@dataclass(frozen=True)
class DoGParams:
    """Static DoG detector knobs (same fields and defaults as the twin)."""

    extremum_thres: float = 0.01
    edge_ratio: float = 10.0
    refine_iters: int = 5
    border: int = 1
    capacity: int = 1024  # max keypoints kept per octave
    edge_test: bool = True  # disable for detectors with built-in edge
                            # suppression (Harris / DoH)


def _stencil_extrema(dog: torch.Tensor):
    """26-neighbour strict local max/min masks over a (..., S, H, W) stack.

    Returns (is_max, is_min) for interior scales (..., S-2, H, W) aligned
    with dog[..., 1:-1, :, :].
    """
    lead = dog.shape[:-3]
    S, H, W = dog.shape[-3:]
    neigh_max = torch.full(lead + (S - 2, H, W), float("-inf"),
                           dtype=dog.dtype, device=dog.device)
    neigh_min = torch.full(lead + (S - 2, H, W), float("inf"),
                           dtype=dog.dtype, device=dog.device)
    pad = F.pad(dog.reshape((-1, S, H, W)), (1, 1, 1, 1),
                mode="replicate").reshape(lead + (S, H + 2, W + 2))
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                sl = pad[..., 1 + ds: S - 1 + ds, 1 + dy: 1 + dy + H,
                         1 + dx: 1 + dx + W]
                neigh_max = torch.maximum(neigh_max, sl)
                neigh_min = torch.minimum(neigh_min, sl)
    center = dog[..., 1:-1, :, :]
    return center > neigh_max, center < neigh_min


def _solve3(hcomp, g: torch.Tensor, reg: float = 1e-12) -> torch.Tensor:
    """Closed-form symmetric 3x3 solve via the adjugate on flat component
    columns. hcomp = (hss, hyy, hxx, hsy, hsx, hyx)."""
    hss, hyy, hxx, hsy, hsx, hyx = hcomp
    a, b, c = hss + reg, hsy, hsx
    d, e, f = hsy, hyy + reg, hyx
    gg, h, i = hsx, hyx, hxx + reg
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * gg - d * i
    E = a * i - c * gg
    F_ = c * d - a * f
    G = d * h - e * gg
    Hh = b * gg - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    x0 = (A * g[..., 0] + B * g[..., 1] + C * g[..., 2]) / det
    x1 = (D * g[..., 0] + E * g[..., 1] + F_ * g[..., 2]) / det
    x2 = (G * g[..., 0] + Hh * g[..., 1] + I * g[..., 2]) / det
    return torch.stack([x0, x1, x2], dim=-1)


def _derivative_field(dog: torch.Tensor) -> torch.Tensor:
    """Dense flat derivative field of a (..., S, H, W) stack: (...,
    S*H*W, 10) rows [c, gs, gy, gx, hss, hyy, hxx, hsy, hsx, hyx] (central
    differences, edge-replicated borders)."""
    lead = dog.shape[:-3]
    S, H, W = dog.shape[-3:]
    pad = F.pad(dog.reshape((-1, 1, S, H, W)), (1, 1, 1, 1, 1, 1),
                mode="replicate")[:, 0]

    def sh(ds, dy, dx):
        return pad[:, 1 + ds:1 + ds + S, 1 + dy:1 + dy + H,
                   1 + dx:1 + dx + W]

    c = dog.reshape((-1, S, H, W))
    gs = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    hss = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hsy = 0.25 * (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0)
                  + sh(-1, -1, 0))
    hsx = 0.25 * (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1)
                  + sh(-1, 0, -1))
    hyx = 0.25 * (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1)
                  + sh(0, -1, -1))
    return torch.stack([c, gs, gy, gx, hss, hyy, hxx, hsy, hsx, hyx],
                       dim=-1).reshape(lead + (S * H * W, 10))


def _frame_base(lead: tuple, n: int, device) -> torch.Tensor:
    """The first row of each frame in a frame-folded array of ``n`` rows
    per frame, shaped ``lead + (1,)`` (``(1,)`` zero without leading
    dims)."""
    return (torch.arange(math.prod(lead), device=device) * n).reshape(
        lead + (1,))


def _newton_step(field: torch.Tensor, W: int, HW: int, s, y, x,
                 base=0):
    """Rows of the flat (rows, 10) field at (s, y, x) past ``base`` (a
    frame's first row) and the Newton offset h = -H^-1 g; the keypoint
    dims of s, y, x are kept."""
    lin = base + s * HW + y * W + x
    rows = field.index_select(0, lin.reshape(-1)).reshape(lin.shape + (10,))
    g = rows[..., 1:4]
    hcomp = tuple(rows[..., 4 + i] for i in range(6))
    return rows, g, -_solve3(hcomp, g)


def detect_dog_octave(dog: torch.Tensor, params: DoGParams = DoGParams()):
    """Detect & refine DoG extrema in one octave stack.

    Args:
      dog: (..., S+2, H, W) DoG stack of one octave; leading dims are
        independent frames (a batch), each selected and refined on its
        own.
      params: static detector configuration.

    Returns a dict of (..., K) tensors with capacity K = params.capacity:
      x, y: float32 refined positions in octave pixel coords.
      s: float32 refined *scale index* (continuous, in [1, S]).
      value: float32 interpolated DoG value.
      mask: bool validity.
    """
    lead = dog.shape[:-3]
    S, H, W = dog.shape[-3:]
    K = params.capacity
    is_max, is_min = _stencil_extrema(dog)
    mask = is_max | is_min
    # Threshold pre-filter (80% of the final threshold) and border exclusion.
    b = max(params.border, 1)
    interior = torch.zeros((H, W), dtype=torch.bool, device=dog.device)
    interior[b:H - b, b:W - b] = True
    center = dog[..., 1:-1, :, :]
    mask = mask & (center.abs() >= 0.8 * params.extremum_thres) & interior

    score = torch.where(mask, center.abs(),
                        torch.full_like(center, -1.0)).reshape(lead + (-1,))
    k_eff = min(K, score.shape[-1])
    vals, idx = bucketed_top_k(score, k_eff)
    if k_eff < K:
        vals = torch.cat([vals, vals.new_full(lead + (K - k_eff,), -1.0)],
                         dim=-1)
        idx = torch.cat([idx, idx.new_zeros(lead + (K - k_eff,))], dim=-1)
    valid = vals > 0
    s = idx // (H * W) + 1  # scale index into the full stack
    rem = idx % (H * W)
    y = rem // W
    x = rem % W

    # Newton refinement with integer re-centring, on the frame-folded field.
    field = _derivative_field(dog).reshape(-1, 10)
    HW = H * W
    base = _frame_base(lead, S * HW, dog.device)
    done = torch.zeros(lead + (K,), dtype=torch.bool, device=dog.device)
    for _ in range(params.refine_iters):
        _, _, h = _newton_step(field, W, HW, s, y, x, base)
        # If the spatial offset exceeds 0.6, shift the integer position.
        zero = torch.zeros_like(h[..., 1])
        shift_y = torch.where(h[..., 1].abs() > 0.6, torch.sign(h[..., 1]),
                              zero).long()
        shift_x = torch.where(h[..., 2].abs() > 0.6, torch.sign(h[..., 2]),
                              zero).long()
        moved = (shift_y != 0) | (shift_x != 0)
        do_move = moved & ~done
        y = torch.clamp(y + torch.where(do_move, shift_y, 0), 1, H - 2)
        x = torch.clamp(x + torch.where(do_move, shift_x, 0), 1, W - 2)
        done = done | ~moved

    rows, g, h = _newton_step(field, W, HW, s, y, x, base)
    # Clamp the final sub-pixel offset; reject wild steps (|h| > 1.5).
    ok_step = h.abs().amax(dim=-1) <= 1.5
    h = torch.clamp(h, -1.5, 1.5)
    value = rows[..., 0] + 0.5 * (g * h).sum(dim=-1)

    valid = valid & ok_step & (value.abs() >= params.extremum_thres)
    if params.edge_test:
        # Edge test on the spatial 2x2 Hessian: tr^2 r >= (r+1)^2 det.
        hyy, hxx, hyx = rows[..., 5], rows[..., 6], rows[..., 9]
        tr = hxx + hyy
        det = hxx * hyy - hyx * hyx
        r = params.edge_ratio
        valid = valid & ~(tr * tr * r >= (r + 1.0) ** 2 * det)

    return {
        "x": x.float() + h[..., 2],
        "y": y.float() + h[..., 1],
        "s": s.float() + h[..., 0],
        "value": value,
        "mask": valid,
    }
