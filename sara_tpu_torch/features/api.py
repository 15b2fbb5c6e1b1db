"""Top-level SIFT keypoint computation: detect + orient + describe.

Twin of ``sara_tpu/features/api.py``: Gaussian/DoG pyramid, then per octave
extrema -> orientations -> descriptors with fixed capacities, merged into
one fixed-capacity :class:`~sara_tpu_torch.core.types.Keypoints` in input
image coordinates. It runs the reference's CPU branch (float32 maps,
orientation maps at full resolution) on the CPU and on the card alike.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.features.dog import DoGParams, detect_dog_octave
from sara_tpu_torch.features.orientation import (find_orientation_peaks,
                                                 lowe_smooth,
                                                 orientation_maps,
                                                 sample_orientation_maps)
from sara_tpu_torch.features.sift import (sift_descriptors,
                                          sift_descriptors_field)
from sara_tpu_torch.image.differential import gradient
from sara_tpu_torch.image.pyramid import (PyramidParams, dog_pyramid,
                                          gaussian_pyramid)
from sara_tpu_torch.ops.topk import chunked_top_k


@dataclass(frozen=True)
class SIFTParams:
    """Static configuration for the SIFT pipeline: the same fields and
    defaults as the JAX twin.

    ``desc_sampler``: "gather" (row gathers, nearest or bilinear per
    ``desc_sample_nearest``), "kernel" (the CUDA patch sampler, always
    bilinear; the JAX twin calls it "pallas") or "auto" (kernel on a CUDA
    device). ``low_precision`` and ``orientation_downsample=0`` pick bf16
    maps and stride 2 only on a TPU in the reference; the port follows the
    reference's other branch: float32 and stride 1.
    """

    pyramid: PyramidParams = field(
        default_factory=lambda: PyramidParams(first_octave=-1))
    dog: DoGParams = field(default_factory=lambda: DoGParams(
        capacity=4096, refine_iters=2))
    max_orientations: int = 2
    total_capacity: int = 8192
    descriptor_bilinear: bool = False
    low_precision: bool = True
    descriptor_field: bool = True
    orientation_downsample: int = 0  # 0 = auto (1 here); 1 or 2 forces it
    hist_sample_nearest: bool = False
    desc_sample_nearest: bool = True
    desc_sampler: str = "gather"


def _process_octave(gauss: torch.Tensor, dog: torch.Tensor,
                    params: SIFTParams, sigmas: tuple) -> dict:
    """One octave: extrema -> orientations -> descriptors. Fixed shapes."""
    det = detect_dog_octave(dog, params.dog)
    # The top Gaussian only feeds the last DoG level; drop it.
    gx, gy = gradient(gauss[:-1])
    ds = params.orientation_downsample if params.orientation_downsample > 0 \
        else 1

    maps = orientation_maps(gx, gy, sigmas[:-1], downsample=ds)
    hist = lowe_smooth(sample_orientation_maps(
        maps, det["x"], det["y"], det["s"], downsample=ds,
        bilinear=not params.hist_sample_nearest))
    theta, tvalid = find_orientation_peaks(
        hist, max_peaks=params.max_orientations)

    # Replicate each keypoint per orientation peak.
    K = det["x"].shape[0]
    P = params.max_orientations
    x, y, s, val, mask = (det[k].repeat_interleave(P)
                          for k in ("x", "y", "s", "value", "mask"))
    mask = mask & tvalid.reshape(-1)
    th = theta.reshape(-1)

    # Compact valid slots to the front and describe K + K//4 of them
    # (second orientations beyond that are dropped, weakest index last).
    K2 = K + K // 4
    order = torch.argsort((~mask).to(torch.int32), stable=True)[:K2]
    x, y, s, val, th, mask = (a[order] for a in (x, y, s, val, th, mask))

    if params.descriptor_field:
        desc = sift_descriptors_field(
            maps, x, y, s, th, sigmas[:-1], downsample=ds,
            bilinear=not params.desc_sample_nearest,
            sampler=params.desc_sampler)
    else:
        desc = sift_descriptors(gx, gy, x, y, s, th, sigmas[:-1],
                                bilinear=params.descriptor_bilinear)
    return {"x": x, "y": y, "s": s, "value": val, "theta": th,
            "desc": desc, "mask": mask}


def compute_sift_keypoints(image, params: SIFTParams = SIFTParams(),
                           device: str | torch.device | None = None
                           ) -> Keypoints:
    """SIFT keypoints + descriptors of a (H, W) float image.

    ``image`` is a numpy array or a tensor; it is moved to ``device``
    (None = the CUDA device; raises without one). Returns a fixed-capacity
    Keypoints (capacity = params.total_capacity) with positions in input
    image pixels and absolute sigmas, keeping the strongest responses across
    octaves.
    """
    dev = resolve_device(device)
    image = torch.as_tensor(image).to(dev, torch.float32)

    gp = gaussian_pyramid(image, params.pyramid)
    dg = dog_pyramid(gp)

    chunks = []
    for oct_idx, (gauss, dog) in enumerate(zip(gp.octaves, dg.octaves)):
        # Adaptive per-octave capacity: small octaves cannot produce
        # anywhere near the full budget.
        s_, h_, w_ = dog.shape
        cap = min(params.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        oct_params = dataclasses.replace(params, dog=dataclasses.replace(
            params.dog, capacity=cap))
        out = _process_octave(gauss, dog, oct_params, gp.sigmas)
        scale_factor = gp.octave_scales[oct_idx]
        sigma = params.pyramid.sigma_initial * torch.pow(
            torch.full((), params.pyramid.k, dtype=torch.float32, device=dev),
            out["s"])
        chunks.append(Keypoints(
            xy=torch.stack([out["x"], out["y"]], dim=-1) * scale_factor,
            scale=sigma * scale_factor,
            orientation=out["theta"],
            response=out["value"],
            descriptors=out["desc"],
            mask=out["mask"],
        ))

    merged = Keypoints(*(torch.cat(parts, dim=0) for parts in zip(*chunks)))

    # Keep the strongest total_capacity responses (masked rows last).
    cap = params.total_capacity
    if merged.capacity <= cap:
        pad = cap - merged.capacity
        return Keypoints(*(torch.cat([f, f.new_zeros((pad,) + f.shape[1:])])
                           for f in merged))
    score = torch.where(merged.mask, merged.response.abs(),
                        torch.full_like(merged.response, float("-inf")))
    _, idx = chunked_top_k(score, cap)
    return Keypoints(*(f[idx] for f in merged))
