"""Resize and interpolation.

Twin of the parts of ``sara_tpu/image/transform.py`` that the SIFT frontend
uses. ``downscale2`` is the strided slice of the reference's CPU branch (its
TPU branch, selection-matrix matmuls, was a TPU workaround).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(image: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` (H, W) or (H, W, C) at float coords (x, y), clamped.

    x, y may have any (matching) shape; output has that shape (+ C).
    """
    H, W = image.shape[0], image.shape[1]
    x = x.clamp(0.0, W - 1.0)
    y = y.clamp(0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0
    fy = y - y0
    if image.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = image[y0, x0] * (1 - fx) + image[y0, x1] * fx
    bot = image[y1, x0] * (1 - fx) + image[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def resize_bilinear(image: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Bilinear resize of (H, W) or (H, W, C), half-pixel centres.

    Matches ``jax.image.resize(method="linear")``: ``align_corners=False``,
    and an antialiased (widened) triangle when shrinking, as JAX does.
    """
    chw = image.dim() == 3
    x = image.permute(2, 0, 1)[None] if chw else image[None, None]
    shrink = out_h < image.shape[0] or out_w < image.shape[1]
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return x[0].permute(1, 2, 0) if chw else x[0, 0]


def downscale2(image: torch.Tensor) -> torch.Tensor:
    """Decimate by 2 (every other pixel), the reference's octave step."""
    return image[..., ::2, ::2]


def upscale2(image: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample (the first_octave = -1 enlargement)."""
    H, W = image.shape[0], image.shape[1]
    return resize_bilinear(image, 2 * H, 2 * W)


def warp_bilinear(image: torch.Tensor, map_x: torch.Tensor,
                  map_y: torch.Tensor, fill_value: float = 0.0
                  ) -> torch.Tensor:
    """Dense warp: out[i, j] = image(map_y[i,j], map_x[i,j]), bilinear.

    Out-of-bounds samples get ``fill_value``. This is the undistortion warp
    (reference: SfM/Odometry/ImageDistortionCorrector.hpp:46-59).
    """
    H, W = image.shape[0], image.shape[1]
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    out = bilinear_sample(image, map_x, map_y)
    if image.dim() == 3:
        inside = inside[..., None]
    return torch.where(inside, out, torch.as_tensor(fill_value, dtype=out.dtype,
                                                    device=out.device))


def warp_homography(image: torch.Tensor, H_inv: torch.Tensor, out_h: int,
                    out_w: int, fill_value: float = 0.0) -> torch.Tensor:
    """Warp by a homography: out pixel p gets image(H_inv @ p)."""
    dev = image.device
    u = torch.arange(out_w, dtype=torch.float32, device=dev)
    v = torch.arange(out_h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    p = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)   # (H, W, 3)
    q = p @ torch.as_tensor(H_inv, dtype=torch.float32, device=dev).T
    mx = q[..., 0] / q[..., 2]
    my = q[..., 1] / q[..., 2]
    return warp_bilinear(image, mx, my, fill_value)
