"""Dense SIFT: descriptors on a regular grid.

Twin of ``sara_tpu/features/dense.py`` (reference:
cpp/src/DO/Sara/FeatureDescriptors/DenseFeature.hpp): the exact-grid
``sift_descriptors`` over a grid of upright keypoints at one scale (the
descriptor field's sampler, kernel K1, is not on this path, as in the
twin).
"""

from __future__ import annotations

import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.features.sift import sift_descriptors
from sara_tpu_torch.image.differential import gradient
from sara_tpu_torch.image.filtering import gaussian_blur


def dense_sift(image, step: int = 8, sigma: float = 1.6,
               device: str | torch.device | None = None):
    """128-D descriptors on a regular grid (upright, fixed scale), on
    ``device`` (None: the card).

    Returns (xy (N, 2), descriptors (N, 128)) with N = len(grid).
    """
    image = torch.as_tensor(image).to(resolve_device(device), torch.float32)
    H, W = image.shape
    sm = gaussian_blur(image, sigma)
    gx, gy = gradient(sm)
    f32 = dict(dtype=torch.float32, device=image.device)
    ys = torch.arange(step, H - step, step, **f32)
    xs = torch.arange(step, W - step, step, **f32)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    x = xx.reshape(-1)
    y = yy.reshape(-1)
    n = x.shape[0]
    s = torch.zeros((n,), **f32)
    theta = torch.zeros((n,), **f32)
    desc = sift_descriptors(gx[None], gy[None], x, y, s, theta, (sigma,))
    return torch.stack([x, y], dim=-1), desc
