"""Alternative scale-space detectors: LoG, Harris-Laplace, DoH (Hessian).

Twin of ``sara_tpu/features/multiscale.py`` (reference:
cpp/src/DO/Sara/FeatureDetectors/LoG.hpp:34 ComputeLoGExtrema,
Harris.hpp:53-97 ComputeHarrisLaplaceCorners + scale_adapted_harris_cornerness,
Hessian.hpp:60-171 ComputeDoHExtrema / ComputeHessianLaplaceMaxima).

All reuse the 26-neighbour extremum + refinement of
``features/dog.py::detect_dog_octave`` (or the 8-neighbour spatial maxima
of :func:`detect_2d_maxima_octave`) over per-octave response stacks
computed from the Gaussian pyramid.
"""

from __future__ import annotations

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.features.dog import DoGParams, detect_dog_octave
from sara_tpu_torch.image.differential import gradient, hessian, laplacian
from sara_tpu_torch.image.filtering import gaussian_blur
from sara_tpu_torch.image.pyramid import PyramidParams, gaussian_pyramid
from sara_tpu_torch.ops.topk import bucketed_top_k
from sara_tpu_torch.utils.host import put


def _sig(gauss: torch.Tensor, sigmas) -> torch.Tensor:
    return put(np.asarray(sigmas, np.float32), gauss.device)[
        : gauss.shape[0], None, None].to(gauss.dtype)


def log_stack(gauss: torch.Tensor, sigmas) -> torch.Tensor:
    """Scale-normalized Laplacian responses per octave scale."""
    sig = _sig(gauss, sigmas)
    return laplacian(gauss) * sig * sig


def doh_stack(gauss: torch.Tensor, sigmas) -> torch.Tensor:
    """Scale-normalized determinant-of-Hessian responses."""
    dxx, dxy, dyy = hessian(gauss)
    sig = _sig(gauss, sigmas)
    return (dxx * dyy - dxy * dxy) * sig ** 4


def harris_stack(gauss: torch.Tensor, sigmas, kappa: float = 0.04,
                 sigma_i_factor: float = 3.0) -> torch.Tensor:
    """Scale-adapted Harris cornerness per scale
    (reference: Harris.hpp:97 scale_adapted_harris_cornerness, integration
    scale sigma_I = 3 sigma_D at each scale's derivative scale). The three
    moment products of a scale are blurred in one batched call."""
    levels = []
    for s in range(gauss.shape[0]):
        sd = float(sigmas[s]) if s < len(sigmas) else float(sigmas[-1])
        gx, gy = gradient(gauss[s])
        m = gaussian_blur(torch.stack([gx * gx, gx * gy, gy * gy]),
                          sigma_i_factor * sd)
        mxx, mxy, myy = m[0], m[1], m[2]
        det = mxx * myy - mxy * mxy
        tr = mxx + myy
        levels.append((sd * sd) ** 2 * (det - kappa * tr * tr))
    return torch.stack(levels, dim=0)


def _keypoints(det: dict, params: PyramidParams, scale_factor: float
               ) -> Keypoints:
    """One octave's detections as Keypoints in image coordinates."""
    x = det["x"]
    sigma = params.sigma_initial * torch.pow(
        torch.full((), params.k, dtype=torch.float32, device=x.device),
        det["s"])
    K = x.shape[0]
    return Keypoints(
        xy=torch.stack([det["x"], det["y"]], dim=-1) * scale_factor,
        scale=sigma * scale_factor,
        orientation=x.new_zeros((K,)),
        response=det["value"],
        descriptors=x.new_zeros((K, 128)),
        mask=det["mask"],
    )


def _detect(image, make_stack, detect, params: PyramidParams,
            device) -> Keypoints:
    """The detectors' common path: build the pyramid, compute each
    octave's response stack, detect, rescale to image coordinates,
    concatenate."""
    image = torch.as_tensor(image).to(resolve_device(device), torch.float32)
    gp = gaussian_pyramid(image, params)
    chunks = [_keypoints(detect(make_stack(gauss, gp.sigmas)), params,
                         gp.octave_scales[o])
              for o, gauss in enumerate(gp.octaves)]
    return Keypoints(*(torch.cat(parts, dim=0) for parts in zip(*chunks)))


def compute_log_keypoints(image, params: PyramidParams = PyramidParams(),
                          thres: float = 0.01, capacity: int = 1024,
                          device: str | torch.device | None = None
                          ) -> Keypoints:
    """LoG extrema of a (H, W) image on ``device`` (None: the card)."""
    dp = DoGParams(extremum_thres=thres, capacity=capacity)
    return _detect(image, log_stack, lambda st: detect_dog_octave(st, dp),
                   params, device)


def compute_doh_keypoints(image, params: PyramidParams = PyramidParams(),
                          thres: float = 1e-5, capacity: int = 1024,
                          device: str | torch.device | None = None
                          ) -> Keypoints:
    """Determinant-of-Hessian extrema on ``device`` (None: the card)."""
    dp = DoGParams(extremum_thres=thres, capacity=capacity, edge_test=False)
    return _detect(image, doh_stack, lambda st: detect_dog_octave(st, dp),
                   params, device)


def detect_2d_maxima_octave(stack: torch.Tensor, thres: float, capacity: int,
                            border: int = 1):
    """Per-scale spatial (8-neighbor) maxima of a (S, H, W) response stack
    with sub-pixel 2-D quadratic refinement. Corner-style detection where a
    scale-space extremum is too strict (Harris: the cornerness is often
    monotonic in scale) — matches the reference's corner scanning
    (reference: ImageProcessing/LocalExtremum.hpp local_maxima +
    Harris.hpp per-scale corner lists)."""
    S, H, W = stack.shape
    dev = stack.device
    pad = torch.nn.functional.pad(stack[:, None], (1, 1, 1, 1),
                                  mode="replicate")[:, 0]
    neigh = torch.full((S, H, W), float("-inf"), dtype=stack.dtype,
                       device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(neigh, pad[:, 1 + dy: 1 + dy + H,
                                             1 + dx: 1 + dx + W])
    is_max = (stack > neigh) & (stack >= thres)
    interior = torch.zeros((H, W), dtype=torch.bool, device=dev)
    interior[border:H - border, border:W - border] = True
    is_max = is_max & interior[None]

    score = torch.where(is_max, stack,
                        torch.full_like(stack, float("-inf"))).reshape(-1)
    k_eff = min(capacity, score.shape[0])
    vals, idx = bucketed_top_k(score, k_eff)
    if k_eff < capacity:
        vals = torch.cat([vals, vals.new_full((capacity - k_eff,),
                                              float("-inf"))])
        idx = torch.cat([idx, idx.new_zeros((capacity - k_eff,))])
    valid = torch.isfinite(vals)
    s = idx // (H * W)
    rem = idx % (H * W)
    y = rem // W
    x = rem % W

    # 2-D quadratic refinement on the 3x3 spatial patch.
    offs = torch.arange(-1, 2, device=dev)
    yy = torch.clamp(y[:, None] + offs, 0, H - 1)
    xx = torch.clamp(x[:, None] + offs, 0, W - 1)
    patch = stack[s[:, None, None], yy[:, :, None], xx[:, None, :]]  # (K,3,3)
    gy = 0.5 * (patch[:, 2, 1] - patch[:, 0, 1])
    gx = 0.5 * (patch[:, 1, 2] - patch[:, 1, 0])
    hyy = patch[:, 2, 1] + patch[:, 0, 1] - 2 * patch[:, 1, 1]
    hxx = patch[:, 1, 2] + patch[:, 1, 0] - 2 * patch[:, 1, 1]
    hxy = 0.25 * (patch[:, 2, 2] - patch[:, 2, 0]
                  - patch[:, 0, 2] + patch[:, 0, 0])
    det = hxx * hyy - hxy * hxy
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    dx_ = torch.clamp(-(hyy * gx - hxy * gy) / det, -1.0, 1.0)
    dy_ = torch.clamp(-(hxx * gy - hxy * gx) / det, -1.0, 1.0)
    return {
        "x": x.float() + dx_,
        "y": y.float() + dy_,
        "s": s.float(),
        "value": patch[:, 1, 1],
        "mask": valid,
    }


def compute_harris_laplace_keypoints(image,
                                     params: PyramidParams = PyramidParams(),
                                     thres: float = 1e-8,
                                     capacity: int = 1024,
                                     device: str | torch.device | None = None
                                     ) -> Keypoints:
    """Harris corners per scale with spatial NMS (per-octave programs) on
    ``device`` (None: the card)."""
    return _detect(image, harris_stack,
                   lambda st: detect_2d_maxima_octave(st, thres, capacity),
                   params, device)
