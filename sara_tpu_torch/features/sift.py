"""SIFT descriptor (4x4 spatial bins x 8 orientation bins = 128-D).

Twin of ``sara_tpu/features/sift.py``: the exact-grid descriptor
(:func:`sift_descriptors`, bilinear samples of the gradient components on a
fixed 16x16 grid in the keypoint frame), the field descriptor sampled from
the shared 36-channel orientation maps (:func:`sift_descriptors_field`), and
RootSIFT.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sara_tpu_torch.features.orientation import NUM_BINS
from sara_tpu_torch.ops import patch_sampler
from sara_tpu_torch.utils.host import put

N_SPATIAL = 4     # spatial bins per axis
N_ORI = 8         # orientation bins
T = 4 * N_SPATIAL  # sample grid size (16)
BIN_SCALE_UNIT = 3.0
MAX_BIN_VALUE = 0.2


def _spatial_weights(device=None) -> torch.Tensor:
    """(T, N_SPATIAL) linear interpolation weights of each sample row/col
    into the spatial bins: sample i sits at bin coordinate
    u = (i+0.5)/4 - 0.5; weight to bin r is max(0, 1 - |u - r|)."""
    i = torch.arange(T, dtype=torch.float32, device=device)
    u = (i + 0.5) / (T / N_SPATIAL) - 0.5
    r = torch.arange(N_SPATIAL, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - (u[:, None] - r[None, :]).abs(), min=0.0)


def _gaussian_window(device=None) -> torch.Tensor:
    """(T, T) Gaussian weight, sigma_w = N/2 bin units."""
    i = torch.arange(T, dtype=torch.float32, device=device)
    u = (i + 0.5) / (T / N_SPATIAL) - N_SPATIAL / 2.0
    g = torch.exp(-(u ** 2) / (2.0 * (N_SPATIAL / 2.0) ** 2))
    return g[:, None] * g[None, :]


def _normalize(desc: torch.Tensor) -> torch.Tensor:
    """L2-normalize -> clamp 0.2 -> renormalize."""
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-12)
    desc = torch.clamp(desc, max=MAX_BIN_VALUE)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / torch.clamp(norm, min=1e-12)


def sift_descriptors(gx_stack: torch.Tensor, gy_stack: torch.Tensor,
                     x, y, s, theta, sigmas,
                     bilinear: bool = True) -> torch.Tensor:
    """128-D SIFT descriptors of K keypoints in one octave, exact grid.

    Args:
      gx_stack, gy_stack: (S, H, W) gradient component stacks.
      x, y: (K,) positions (octave pixel coords).
      s: (K,) continuous scale index.
      theta: (K,) keypoint orientation (radians).
      sigmas: per-scale sigmas (tuple of floats).
      bilinear: bilinear or nearest samples of the gradient maps.

    Returns (K, 128) float32, L2-normalized with 0.2 clamping.
    """
    S, H, W = gx_stack.shape
    dev = gx_stack.device
    s_idx = torch.clamp(torch.round(s).long(), 0, S - 1)
    sig_table = put(np.asarray(sigmas, np.float32), dev)
    l = BIN_SCALE_UNIT * sig_table[s_idx]

    # Sample positions in the canonical keypoint frame.
    i = torch.arange(T, dtype=torch.float32, device=dev)
    u = (i + 0.5) / (T / N_SPATIAL) - N_SPATIAL / 2.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")  # uu = column, vv = row
    ct, st = torch.cos(theta), torch.sin(theta)
    dx = (ct[:, None, None] * uu - st[:, None, None] * vv) * l[:, None, None]
    dy = (st[:, None, None] * uu + ct[:, None, None] * vv) * l[:, None, None]
    xs = x[:, None, None] + dx  # (K, T, T)
    ys = y[:, None, None] + dy

    maps = torch.stack([gx_stack, gy_stack], dim=-1)  # (S, H, W, 2)
    si3 = s_idx[:, None, None]
    inside = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
    xc = xs.clamp(0.0, W - 1.0)
    yc = ys.clamp(0.0, H - 1.0)
    if bilinear:
        x0 = torch.floor(xc).long()
        y0 = torch.floor(yc).long()
        x1 = torch.clamp(x0 + 1, max=W - 1)
        y1 = torch.clamp(y0 + 1, max=H - 1)
        fx = (xc - x0)[..., None]
        fy = (yc - y0)[..., None]
        g = (maps[si3, y0, x0].float() * (1 - fx) * (1 - fy)
             + maps[si3, y0, x1].float() * fx * (1 - fy)
             + maps[si3, y1, x0].float() * (1 - fx) * fy
             + maps[si3, y1, x1].float() * fx * fy)  # (K, T, T, 2)
    else:
        xn = torch.round(xc).long()
        yn = torch.round(yc).long()
        g = maps[si3, yn, xn].float()
    gxs = g[..., 0]
    gys = g[..., 1]
    m = torch.sqrt(gxs * gxs + gys * gys)
    o = torch.atan2(gys, gxs)

    # Rotate gradient orientations into the keypoint frame, bin over [0, 2pi).
    rel = torch.remainder(o - theta[:, None, None], 2.0 * math.pi)
    ob = rel / (2.0 * math.pi) * N_ORI
    o0 = torch.remainder(torch.floor(ob).long(), N_ORI)
    o1 = torch.remainder(o0 + 1, N_ORI)
    fo = ob - torch.floor(ob)

    w = m * _gaussian_window(dev) * inside.to(m.dtype)  # (K, T, T)
    eye = torch.eye(N_ORI, dtype=w.dtype, device=dev)
    ori_w = eye[o0] * (1.0 - fo[..., None]) + eye[o1] * fo[..., None]

    Wrow = _spatial_weights(dev)  # (T, 4)
    desc = torch.einsum("ir,jc,kij,kijb->krcb", Wrow, Wrow, w, ori_w)
    return _normalize(desc.reshape(desc.shape[0], -1))


def root_sift(desc: torch.Tensor) -> torch.Tensor:
    """RootSIFT transform: L1-normalize then sqrt."""
    l1 = desc.abs().sum(dim=-1, keepdim=True)
    return torch.sqrt(desc / torch.clamp(l1, min=1e-12))


def sift_descriptors_field(maps: torch.Tensor, x, y, s, theta, sigmas,
                           downsample: int = 1,
                           bilinear: bool = True,
                           sampler: str = "auto") -> torch.Tensor:
    """128-D descriptors sampled from the dense blurred orientation maps.

    Each of the 4x4 spatial bins reads one sample of the shared 36-channel
    orientation field at the rotated bin centre, and the 36 fine orientation
    channels collapse into the 8 coarse bins (rotated by theta) with
    circular triangle weights.

    Args:
      maps: (S, Hc, Wc, >=36) from orientation_maps().
      x, y, s, theta: (K,) keypoint geometry (octave pixel coords).
      sigmas: per-scale sigmas (tuple).
      downsample: the maps' stride (must match orientation_maps).
      bilinear: bilinear or nearest samples on the "gather" path.
      sampler: "gather" = row gathers in PyTorch; "kernel" = the patch
        sampler of ops/patch_sampler.py (the CUDA kernel on a CUDA tensor),
        which samples bilinear; "auto" = "kernel" on a CUDA tensor,
        "gather" otherwise. Like the JAX twin's "pallas" sampler, "kernel"
        with ``bilinear=False`` takes nearest gathers where the twin's
        window does not fit (``patch_sampler.tpu_window_fits``); with
        ``bilinear=True`` both paths compute the same function, so every
        geometry goes through the kernel.

    Returns (K, 128) float32, L2-normalized with 0.2 clamping.
    """
    S, Hc, Wc, Cm = maps.shape
    dev = maps.device
    K = x.shape[0]
    s_idx = torch.clamp(torch.round(s).long(), 0, S - 1)
    sig_table = put(np.asarray(sigmas, np.float32), dev)
    l = BIN_SCALE_UNIT * sig_table[s_idx]                 # (K,)

    # Rotated 4x4 bin-centre grid in image coords.
    u = (torch.arange(N_SPATIAL, dtype=torch.float32, device=dev)
         - (N_SPATIAL - 1) / 2.0)
    vv, uu = torch.meshgrid(u, u, indexing="ij")          # (4, 4)
    ct, st = torch.cos(theta), torch.sin(theta)
    dx = (ct[:, None, None] * uu - st[:, None, None] * vv) * l[:, None, None]
    dy = (st[:, None, None] * uu + ct[:, None, None] * vv) * l[:, None, None]
    xs = (x[:, None, None] + dx).reshape(K, -1)            # (K, 16)
    ys = (y[:, None, None] + dy).reshape(K, -1)
    if downsample > 1:
        xs = xs / downsample
        ys = ys / downsample

    if sampler == "auto":
        sampler = "kernel" if maps.is_cuda else "gather"
    # Spread bound of the 4x4 bin centres (radius 1.5 sqrt(2) l).
    rad = 1.5 * math.sqrt(2.0) * BIN_SCALE_UNIT * max(sigmas) / downsample
    if (sampler == "kernel" and not bilinear and not
            patch_sampler.tpu_window_fits(maps.shape, maps.element_size(),
                                          rad)):
        sampler = "gather"
    if sampler == "kernel":
        Fs = patch_sampler.sample_field_patches(
            maps, s_idx, ys, xs, max_sample_radius=rad)[..., :NUM_BINS]
    elif sampler == "gather":
        xc = xs.clamp(0.0, Wc - 1.0)
        yc = ys.clamp(0.0, Hc - 1.0)
        flat = maps.reshape(S * Hc * Wc, Cm)
        base = s_idx[:, None] * (Hc * Wc)

        def take(yy, xx):
            lin = (base + yy * Wc + xx).reshape(-1)
            return flat.index_select(0, lin).reshape(K, -1, Cm) \
                .float()[..., :NUM_BINS]

        if bilinear:
            x0 = torch.floor(xc).long()
            y0 = torch.floor(yc).long()
            x1 = torch.clamp(x0 + 1, max=Wc - 1)
            y1 = torch.clamp(y0 + 1, max=Hc - 1)
            fx = (xc - x0)[..., None]
            fy = (yc - y0)[..., None]
            Fs = (take(y0, x0) * (1 - fx) * (1 - fy)
                  + take(y0, x1) * fx * (1 - fy)
                  + take(y1, x0) * (1 - fx) * fy
                  + take(y1, x1) * fx * fy)                 # (K, 16, 36)
        else:
            Fs = take(torch.round(yc).long(), torch.round(xc).long())
    else:
        raise ValueError(f"unknown sampler {sampler!r}")

    # Collapse 36 fine orientation channels into 8 theta-rotated coarse bins
    # with circular triangle weights (bins centred at rel = o * 45 deg).
    alpha = ((torch.arange(NUM_BINS, dtype=torch.float32, device=dev) + 0.5)
             * (2 * math.pi / NUM_BINS))
    ob = (alpha[None, :] - theta[:, None]) / (2 * math.pi) * N_ORI  # (K, 36)
    o = torch.arange(N_ORI, dtype=torch.float32, device=dev)
    d = (torch.remainder(ob[..., None] - o[None, None, :] + N_ORI / 2, N_ORI)
         - N_ORI / 2).abs()
    wfo = torch.clamp(1.0 - d, min=0.0)                    # (K, 36, 8)

    # Global Gaussian window over the patch, sigma = N/2 bin units.
    g = torch.exp(-(uu ** 2 + vv ** 2) / (2.0 * (N_SPATIAL / 2.0) ** 2))
    desc = torch.einsum("knf,kfo->kno", Fs, wfo) * g.reshape(1, -1, 1)
    return _normalize(desc.reshape(K, N_SPATIAL * N_SPATIAL * N_ORI))
