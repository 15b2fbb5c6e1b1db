"""Differential operators: central-difference gradients.

Twin of the part of ``sara_tpu/image/differential.py`` that the SIFT
frontend uses: central differences with replicated borders, over whole
images and any leading batch dims.
"""

from __future__ import annotations

import torch


def _shift(image: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication: out[y, x] = in[y+dy, x+dx] (clamped)."""
    H, W = image.shape[-2], image.shape[-1]
    ys = torch.clamp(torch.arange(H, device=image.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=image.device) + dx, 0, W - 1)
    return image.index_select(-2, ys).index_select(-1, xs)


def gradient(image: torch.Tensor):
    """Central-difference gradient (gx, gy), each (..., H, W)."""
    gx = 0.5 * (_shift(image, 0, 1) - _shift(image, 0, -1))
    gy = 0.5 * (_shift(image, 1, 0) - _shift(image, -1, 0))
    return gx, gy
