"""Dominant gradient orientation assignment.

Twin of ``sara_tpu/features/orientation.py``. A Gaussian-weighted
orientation histogram at a point is a Gaussian blur of per-pixel binned
magnitude maps evaluated there, so per scale the module builds dense
(36, H, W) binned maps, blurs them with sigma_w = 1.5 sigma_s (the
reference's CPU branch: one replicate-padded separable convolution per
scale), and each keypoint reads its 36-vector with bilinear taps.
Leading dims before the scale axis are frames (a batch): each scale's blur
is one convolution over every frame's 36 planes (36 planes or 36·B, the
CPU's oneDNN rounds each alike), and the keypoints of frame b read the
frame-folded maps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sara_tpu_torch.features.dog import _frame_base
from sara_tpu_torch.image.filtering import separable_conv2d

NUM_BINS = 36


def _binned_magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(..., H, W) gradients -> (..., 36, H, W) hard-binned magnitude maps."""
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    two_pi = 2.0 * math.pi
    frac = torch.remainder(ori, two_pi) / two_pi * NUM_BINS
    b = torch.remainder(torch.floor(frac).long(), NUM_BINS)
    bins = torch.arange(NUM_BINS, device=b.device).view(NUM_BINS, 1, 1)
    onehot = (b.unsqueeze(-3) == bins).to(mag.dtype)
    return onehot * mag.unsqueeze(-3)


def orientation_maps(gx_stack: torch.Tensor, gy_stack: torch.Tensor,
                     sigmas, radius_factor: float = 1.5,
                     compute_dtype=None, downsample: int = 1) -> torch.Tensor:
    """Dense Gaussian-blurred 36-bin magnitude maps of (..., S, H, W)
    gradient stacks, (..., S, Hc, Wc, 36), contiguous, in ``compute_dtype``
    (default: the gradients' dtype).

    The blur sigma_w = radius_factor * sigma_s per scale equals both the
    orientation-histogram window and the descriptor's spatial-bin
    half-width, so one set of maps serves both stages. With
    ``compute_dtype=torch.bfloat16`` the binned maps, the taps and both
    blur passes are bfloat16, as in the reference's CPU branch with the
    same argument.
    """
    S = gx_stack.shape[-3]
    dense = _binned_magnitude(gx_stack, gy_stack)     # (..., S, 36, H, W)
    if compute_dtype is not None:
        dense = dense.to(compute_dtype)

    stride = downsample
    sig_eff = [radius_factor * float(sg) for sg in sigmas[:S]]
    radii = [max(1, int(math.ceil(3.0 * sw))) for sw in sig_eff]
    per_scale = []
    for si in range(S):
        sw = sig_eff[si]
        xs = np.arange(-radii[si], radii[si] + 1, dtype=np.float64)
        taps = np.exp(-(xs * xs) / (2.0 * sw * sw))    # unnormalized
        per_scale.append(separable_conv2d(dense[..., si, :, :, :], taps,
                                          taps))
    maps = torch.stack(per_scale, dim=-4)[..., ::stride, ::stride]
    return maps.movedim(-3, -1).contiguous()        # (..., S, Hc, Wc, 36)


def sample_orientation_maps(maps: torch.Tensor, x, y, s,
                            downsample: int = 1,
                            bilinear: bool = True) -> torch.Tensor:
    """Read each keypoint's 36-vector from the dense maps (..., S, Hc, Wc,
    Cm): x, y, s (..., K) give (..., K, 36) f32.

    The frame and scale indices fold into one flat row gather;
    ``bilinear=False`` reads one nearest row per keypoint instead of four.
    """
    lead = maps.shape[:-4]
    S, Hc, Wc, Cm = maps.shape[-4:]     # Cm may be padded (>= 36)
    s_idx = torch.clamp(torch.round(s).long(), 0, S - 1)
    if downsample > 1:
        x = x / downsample
        y = y / downsample
    xc = x.clamp(0.0, Wc - 1.0)
    yc = y.clamp(0.0, Hc - 1.0)
    flat = maps.reshape(-1, Cm)
    base = (_frame_base(lead, S, maps.device) + s_idx) * (Hc * Wc)

    def take(yy, xx):
        lin = base + yy * Wc + xx
        return flat.index_select(0, lin.reshape(-1)).reshape(
            lin.shape + (Cm,)).float()[..., :NUM_BINS]

    if not bilinear:
        return take(torch.round(yc).long(), torch.round(xc).long())

    x0 = torch.floor(xc).long()
    y0 = torch.floor(yc).long()
    x1 = torch.clamp(x0 + 1, max=Wc - 1)
    y1 = torch.clamp(y0 + 1, max=Hc - 1)
    fx = (xc - x0)[..., None].float()
    fy = (yc - y0)[..., None].float()
    return (take(y0, x0) * (1 - fx) * (1 - fy)
            + take(y0, x1) * fx * (1 - fy)
            + take(y1, x0) * (1 - fx) * fy
            + take(y1, x1) * fx * fy)


def orientation_histograms(gx_stack: torch.Tensor, gy_stack: torch.Tensor,
                           x, y, s, sigmas, radius_factor: float = 1.5,
                           compute_dtype=None, downsample: int = 1
                           ) -> torch.Tensor:
    """36-bin Gaussian-weighted orientation histograms of K keypoints,
    (K, 36) float32: :func:`orientation_maps` read by
    :func:`sample_orientation_maps`."""
    maps = orientation_maps(gx_stack, gy_stack, sigmas,
                            radius_factor=radius_factor,
                            compute_dtype=compute_dtype,
                            downsample=downsample)
    return sample_orientation_maps(maps, x, y, s, downsample=downsample)


def lowe_smooth(hist: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Circular box-3 smoothing, 6 iterations."""
    for _ in range(iters):
        hist = (torch.roll(hist, 1, dims=-1) + hist
                + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def find_orientation_peaks(hist: torch.Tensor, max_peaks: int = 3,
                           peak_ratio: float = 0.8):
    """Local maxima >= peak_ratio * global max, parabola-refined.

    Returns (orientations (K, max_peaks) radians in [-pi, pi), valid mask).
    """
    left = torch.roll(hist, 1, dims=-1)
    right = torch.roll(hist, -1, dims=-1)
    gmax = hist.amax(dim=-1, keepdim=True)
    is_peak = ((hist > left) & (hist > right) & (hist >= peak_ratio * gmax)
               & (gmax > 0))

    score = torch.where(is_peak, hist, torch.full_like(hist, -1.0))
    vals, idx = torch.topk(score, max_peaks, dim=-1, sorted=True)
    valid = vals > 0

    hl = torch.gather(left, -1, idx)
    hc = torch.gather(hist, -1, idx)
    hr = torch.gather(right, -1, idx)
    denom = hl - 2.0 * hc + hr
    offset = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom,
                         torch.zeros_like(denom))
    bin_f = idx.float() + offset + 0.5
    theta = bin_f / NUM_BINS * (2.0 * math.pi)
    theta = torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
    return theta, valid


def dominant_orientations(gx_stack, gy_stack, x, y, s, sigmas,
                          max_peaks: int = 3, compute_dtype=None,
                          downsample: int = 1):
    """Histograms -> Lowe smoothing -> peaks: (orientations (K, max_peaks),
    valid mask)."""
    hist = orientation_histograms(gx_stack, gy_stack, x, y, s, sigmas,
                                  compute_dtype=compute_dtype,
                                  downsample=downsample)
    return find_orientation_peaks(lowe_smooth(hist), max_peaks)
