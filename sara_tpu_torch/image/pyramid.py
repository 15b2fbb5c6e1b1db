"""Gaussian / DoG scale-space pyramids.

Twin of ``sara_tpu/image/pyramid.py``: each octave is one ``(S, H_o, W_o)``
tensor, built by the reference's incremental blur cascade (its CPU branch;
the TPU branch's grouped band-matmul octave was a TPU workaround). A
``(B, H, W)`` stack of frames gives ``(B, S, H_o, W_o)`` octaves, what the
reference's ``jax.vmap`` over frames computes: each blur is one convolution
over all B planes of a level.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from sara_tpu_torch.image.filtering import gaussian_blur, planewise
from sara_tpu_torch.image.transform import downscale2, upscale2


@dataclass(frozen=True)
class PyramidParams:
    """Static pyramid configuration (same fields and defaults as the twin)."""

    first_octave: int = 0           # -1 upsamples the input by 2 first.
    scales_per_octave: int = 3      # "S"; octave holds S+3 Gaussians.
    sigma_camera: float = 0.5
    sigma_initial: float = 1.6
    border: int = 8                 # image border excluded from detection.
    max_octaves: int = 99

    @property
    def k(self) -> float:
        return 2.0 ** (1.0 / self.scales_per_octave)

    @property
    def gaussians_per_octave(self) -> int:
        return self.scales_per_octave + 3

    def num_octaves(self, h: int, w: int) -> int:
        if self.first_octave < 0:
            h, w = h * 2, w * 2
        n = int(math.floor(math.log2(min(h, w) / (2.0 * self.border)))) + 1
        return max(1, min(n, self.max_octaves))


class GaussianPyramid(NamedTuple):
    """Octave stacks + geometry metadata.

    octaves:       list of (..., S+3, H_o, W_o) tensors (Gaussian) or
                   (..., S+2, ...) (DoG); the leading dims are the input's.
    octave_scales: pixel scaling factor of each octave relative to the
                   original image (2^octave_index).
    sigmas:        (S+3,) relative sigmas of the scales within an octave.
    """

    octaves: List[torch.Tensor]
    octave_scales: tuple
    sigmas: tuple


def gaussian_pyramid(image: torch.Tensor,
                     params: PyramidParams = PyramidParams()
                     ) -> GaussianPyramid:
    """Build the Gaussian pyramid of a (..., H, W) float image or stack of
    frames: optional x2 upsample, blur from sigma_camera to sigma_initial,
    then per octave an incremental blur cascade; the next octave is seeded
    by decimating the scale whose sigma is 2 * sigma_initial (index S).
    Frames never mix: each blur convolves every plane of a level at once,
    on the CPU each rounded as alone (:func:`~sara_tpu_torch.image.
    filtering.planewise`), so frame b of a stack equals the frame alone."""
    p = params
    k = p.k
    S = p.scales_per_octave
    G = p.gaussians_per_octave

    with planewise():
        x = image.float()
        if p.first_octave < 0:
            x = upscale2(x)
            camera = 2.0 * p.sigma_camera
        else:
            camera = p.sigma_camera

        sigma0 = p.sigma_initial
        delta = math.sqrt(max(sigma0 * sigma0 - camera * camera, 1e-6))
        x = gaussian_blur(x, delta)

        n_oct = p.num_octaves(image.shape[-2], image.shape[-1])
        sigmas = tuple(sigma0 * (k ** s) for s in range(G))
        octaves = []
        scales = []
        base = x
        for o in range(n_oct):
            levels = [base]
            for s in range(1, G):
                # sigma_incr so that sigma_{s-1} (+) sigma_incr = sigma_s.
                sig_prev = sigma0 * (k ** (s - 1))
                sig_incr = sig_prev * math.sqrt(k * k - 1.0)
                levels.append(gaussian_blur(levels[-1], sig_incr))
            stack = torch.stack(levels, dim=-3)
            octaves.append(stack)
            scales.append(2.0 ** (o + p.first_octave))
            base = downscale2(stack[..., S, :, :])
            if min(base.shape[-2:]) < 2 * p.border:
                break
    return GaussianPyramid(octaves, tuple(scales[: len(octaves)]), sigmas)


def dog_pyramid(gp: GaussianPyramid) -> GaussianPyramid:
    """Difference-of-Gaussians: adjacent-scale differences per octave."""
    dogs = [oct[..., 1:, :, :] - oct[..., :-1, :, :] for oct in gp.octaves]
    return GaussianPyramid(dogs, gp.octave_scales, gp.sigmas)


def laplacian_pyramid(gp: GaussianPyramid,
                      params: PyramidParams = PyramidParams()
                      ) -> GaussianPyramid:
    """Scale-normalized LoG approximation per octave: each level's
    5-point Laplacian times its sigma squared."""
    from sara_tpu_torch.image.differential import laplacian

    outs = []
    for oct in gp.octaves:
        sig = torch.as_tensor(gp.sigmas, dtype=oct.dtype,
                              device=oct.device)[: oct.shape[0], None, None]
        outs.append(laplacian(oct) * sig * sig)
    return GaussianPyramid(outs, gp.octave_scales, gp.sigmas)
