"""Segmentation / thresholding: Otsu, adaptive threshold, watershed, CCL.

Twin of ``sara_tpu/image/segmentation.py`` (reference:
cpp/src/DO/Sara/ImageProcessing/Otsu.hpp, AdaptiveBinaryThresholding.hpp,
Watershed.hpp / WatershedV2.hpp,
DisjointSets/TwoPassConnectedComponents.hpp).

- Otsu's histogram bins as ``jnp.histogram`` does: the same ``linspace``
  edges (``i`` times the float32 reciprocal of ``bins``, as XLA computes
  them), ``searchsorted(..., side="right")`` (``torch.bucketize(...,
  right=True)``) and the last bin closed. ``torch.histc`` computes the bin
  arithmetically, and a value on an edge can land in the neighbouring bin;
  ``torch.linspace``'s edges differ from these in the last bit at 100
  bins.
- Watershed and connected-component labeling are the twin's fixed-count
  propagations: each step takes the 8-neighbour maximum of the labels
  (outside the image counts as 0, never a wrapped roll) as a 3x3 max-pool
  of the zero-padded labels in float64, exact for every int32 label.
  Labeling is ``iters`` steps of 3 launches, watershed ``levels x
  iters_per_level`` steps of 5; neither reads the device.

Each function runs where its input tensor lies; a host array goes to the
card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sara_tpu_torch.image.filtering import box_blur
from sara_tpu_torch.utils.host import as_tensor


def otsu_threshold(image, bins: int = 256):
    """Otsu's optimal global threshold of a float image in [0, 1].

    Returns (threshold (scalar), binary mask)."""
    image = as_tensor(image)
    x = image.clamp(0.0, 1.0).reshape(-1)
    # jnp.histogram(x, bins, range=(0, 1)): jnp.linspace's edges (XLA
    # computes i / bins as i times the float32 reciprocal of bins, then
    # appends the end point), the bin of x is searchsorted(edges, x,
    # "right") - 1, and x == 1 lands in the last bin.
    recip = float(np.float32(1.0) / np.float32(bins))
    edges = torch.cat([torch.arange(bins, dtype=x.dtype, device=x.device)
                       * recip, x.new_ones(1)])
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    # Counts as float32 adds (exact below 2**24 pixels), as in the twin; a
    # bincount would read its maximum back to the host.
    hist = torch.zeros(bins + 1, dtype=torch.float32,
                       device=x.device).index_add_(
        0, idx, torch.ones_like(x, dtype=torch.float32))[1:]
    p = hist / torch.clamp_min(hist.sum(), 1.0)
    centers = (torch.arange(bins, dtype=torch.float32, device=x.device)
               + 0.5) / bins
    w0 = torch.cumsum(p, 0)
    mu = torch.cumsum(p * centers, 0)
    mu_t = mu[-1]
    w1 = 1.0 - w0
    var_between = (mu_t * w0 - mu) ** 2 / torch.clamp_min(w0 * w1, 1e-12)
    # The variance is flat across empty histogram gaps; take the plateau
    # midpoint like standard implementations.
    m = var_between.max()
    sel = (var_between >= m * (1.0 - 1e-6)).to(torch.float32)
    thr = (centers * sel).sum() / torch.clamp_min(sel.sum(), 1.0)
    return thr, image > thr


def adaptive_threshold(image, radius: int = 15, offset: float = 0.02):
    """Binary mask: pixel > local box mean - offset
    (reference: AdaptiveBinaryThresholding.hpp)."""
    image = as_tensor(image)
    local_mean = box_blur(image, radius)
    return image > (local_mean - offset)


def _shift2(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Non-wrapping 2-D shift (torch.roll would wrap labels across
    borders): out[y, x] = a[y - dy, x - dx], ``fill`` outside."""
    H, W = a.shape
    out = torch.full_like(a, fill)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        a[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _neighbor_max(a: torch.Tensor, fill) -> torch.Tensor:
    """Maximum of each pixel and its 8 neighbours, ``fill`` outside the
    image: one 3x3 max-pool of the ``fill``-padded map, in float64 (exact
    for int32 values)."""
    p = F.pad(a[None, None].to(torch.float64), (1, 1, 1, 1), value=fill)
    return F.max_pool2d(p, 3, stride=1)[0, 0].to(a.dtype)


def _propagate_labels(labels: torch.Tensor, allowed: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """Iterated 8-neighbour max-label propagation restricted to a mask."""
    for _ in range(iters):
        labels = torch.where(allowed, _neighbor_max(labels, 0), labels)
    return labels


def label_connected_components(mask, iters: int = 256):
    """Device-side CCL of a binary mask: unique positive label per
    component (0 = background). Exact once ``iters`` >= component
    diameter."""
    mask = as_tensor(mask, bool)
    H, W = mask.shape
    seed = torch.arange(1, H * W + 1, dtype=torch.int32,
                        device=mask.device).reshape(H, W)
    labels = torch.where(mask, seed, 0)
    return _propagate_labels(labels, mask, iters)


def watershed(image, markers, levels: int = 64, iters_per_level: int = 8):
    """Marker-based watershed by level flooding.

    image: (H, W) relief (float in [0,1]); markers: (H, W) int32 labels
    (>0 seeds, 0 unknown). Floods markers outward level by level (ascending
    relief), which reproduces the reference watershed's basin assignment.
    """
    image = as_tensor(image)
    markers = as_tensor(markers, np.int32, image.device)
    x = image.clamp(0.0, 1.0)
    labels = markers
    # Propagation must not overwrite existing labels; only unlabeled pixels
    # under the current flood level may take a neighboring label.
    for level in range(levels):
        allowed = x <= (level + 1.0) / levels
        for _ in range(iters_per_level):
            grow = (labels == 0) & allowed
            labels = torch.where(grow, _neighbor_max(labels, 0), labels)
    return labels
