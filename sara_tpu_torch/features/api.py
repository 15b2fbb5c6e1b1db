"""Top-level SIFT keypoint computation: detect + orient + describe.

Twin of ``sara_tpu/features/api.py``: Gaussian/DoG pyramid, then per octave
extrema -> orientations -> descriptors with fixed capacities, merged into
one fixed-capacity :class:`~sara_tpu_torch.core.types.Keypoints` in input
image coordinates. ``_compute_sift_batch`` runs a (B, H, W) stack of frames
through the same steps with the frame axis leading, as the reference's
``jax.vmap(_compute_sift_jit)`` does; ``compute_sift_keypoints`` is its
B = 1 case. ``SIFTParams.low_precision`` (bfloat16 orientation maps
and gradients, orientation maps at stride 2) takes effect on every device.
Its default is False, the reference's branch off a TPU (float32, stride 1):
the reference reads the flag only on a TPU, and on the H100 the bfloat16
branch is no faster (PERF.md, F2).
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
from sara_tpu_torch.utils.timing import trace


@dataclass(frozen=True)
class SIFTParams:
    """Static configuration for the SIFT pipeline: the JAX twin's fields
    and defaults, but one.

    ``desc_sampler``: "gather" (row gathers, nearest or bilinear per
    ``desc_sample_nearest``), "kernel" (the CUDA patch sampler, always
    bilinear; the JAX twin calls it "pallas") or "auto" (kernel on a CUDA
    device). ``low_precision`` picks bfloat16 maps, and with
    ``orientation_downsample=0`` stride 2; ``orientation_downsample`` 1 or
    2 forces the stride. One deviation from the twin's defaults:
    ``low_precision`` is False (the twin's True takes effect only on a TPU).
    """

    pyramid: PyramidParams = field(
        default_factory=lambda: PyramidParams(first_octave=-1))
    dog: DoGParams = field(default_factory=lambda: DoGParams(
        capacity=4096, refine_iters=2))
    max_orientations: int = 2
    total_capacity: int = 8192
    descriptor_bilinear: bool = False
    low_precision: bool = False
    descriptor_field: bool = True
    orientation_downsample: int = 0  # 0 = auto (2 under low_precision)
    hist_sample_nearest: bool = False
    desc_sample_nearest: bool = True
    desc_sampler: str = "gather"


def _process_octave(gauss: torch.Tensor, dog: torch.Tensor,
                    params: SIFTParams, sigmas: tuple) -> dict:
    """One octave: extrema -> orientations -> descriptors. Fixed shapes.

    ``gauss`` (..., S+3, H, W) and ``dog`` (..., S+2, H, W) may carry
    leading frame dims; every step keeps them and works per frame (the
    detector's top-k, the compaction's sort), and the returned (..., K2)
    fields carry them too."""
    with trace.span("sift.detect"):
        det = detect_dog_octave(dog, params.dog)
    with trace.span("sift.orient"):
        # The top Gaussian only feeds the last DoG level; drop it.
        gx, gy = gradient(gauss[..., :-1, :, :])
        cdt = torch.bfloat16 if params.low_precision else None
        ds = (params.orientation_downsample
              if params.orientation_downsample > 0
              else (2 if cdt is not None else 1))

        maps = orientation_maps(gx, gy, sigmas[:-1], compute_dtype=cdt,
                                downsample=ds)
        hist = lowe_smooth(sample_orientation_maps(
            maps, det["x"], det["y"], det["s"], downsample=ds,
            bilinear=not params.hist_sample_nearest))
        theta, tvalid = find_orientation_peaks(
            hist, max_peaks=params.max_orientations)

        # Replicate each keypoint per orientation peak.
        K = det["x"].shape[-1]
        P = params.max_orientations
        x, y, s, val, mask = (det[k].repeat_interleave(P, dim=-1)
                              for k in ("x", "y", "s", "value", "mask"))
        mask = mask & tvalid.flatten(-2)
        th = theta.flatten(-2)

    with trace.span("sift.compact"):
        # Compact valid slots to the front and describe K + K//4 of them
        # (second orientations beyond that are dropped, weakest index
        # last).
        K2 = K + K // 4
        order = torch.argsort((~mask).to(torch.int32), dim=-1,
                              stable=True)[..., :K2]
        x, y, s, val, th, mask = (a.gather(-1, order)
                                  for a in (x, y, s, val, th, mask))

    with trace.span("sift.describe"):
        if params.descriptor_field:
            desc = sift_descriptors_field(
                maps, x, y, s, th, sigmas[:-1], downsample=ds,
                bilinear=not params.desc_sample_nearest,
                sampler=params.desc_sampler)
        else:
            desc = sift_descriptors(gx, gy, x, y, s, th, sigmas[:-1],
                                    bilinear=params.descriptor_bilinear,
                                    compute_dtype=cdt)
    return {"x": x, "y": y, "s": s, "value": val, "theta": th,
            "desc": desc, "mask": mask}


def _compute_sift_batch(images, params: SIFTParams = SIFTParams(),
                        device: str | torch.device | None = None
                        ) -> Keypoints:
    """SIFT keypoints + descriptors of a (B, H, W) stack of frames in one
    pass: the counterpart of the reference's ``jax.vmap(_compute_sift_jit)``.

    The frame axis is an explicit leading dim of every step: one
    Gaussian / DoG pyramid of (B, S, h, w) octaves (each blur one
    convolution over the B·S planes), per-frame top-k detection and
    compaction, and descriptors from the frame-folded (B·S, h, w, 36)
    orientation field (with the "kernel" sampler, one launch per octave for
    all B frames). So the launches per call do not grow with B. ``images``
    is a numpy array or a tensor, moved to ``device`` (None = the CUDA
    device; raises without one). Returns a Keypoints whose fields carry
    the frame axis first: xy (B, total_capacity, 2), ..., mask (B,
    total_capacity); frame b equals what :func:`compute_sift_keypoints`
    gives for ``images[b]``.

    Under a ``torch.profiler`` session it records the span ``sift`` (units:
    frames) and within it ``sift.pyramid``, per octave ``sift.detect``,
    ``sift.orient``, ``sift.compact`` and ``sift.describe``, then
    ``sift.merge``; and the counters ``sift.desc_rows`` (rows described),
    ``sift.valid.o<i>`` (octave i's valid rows after compaction) and
    ``sift.kept`` (the returned mask), see ``utils/timing.py::trace``.
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images).to(dev, torch.float32)
    if images.dim() != 3:
        raise ValueError(f"images must be (B, H, W), got "
                         f"{tuple(images.shape)}")
    with trace.span("sift", images.shape[0]):
        kp = _sift_batch(images, params, dev)
        trace.count("sift.kept", kp.mask)
    return kp


def _sift_batch(images: torch.Tensor, params: SIFTParams,
                dev: torch.device) -> Keypoints:
    """The body of :func:`_compute_sift_batch` on a (B, H, W) float32
    stack on ``dev``."""
    B = images.shape[0]
    with trace.span("sift.pyramid", B):
        gp = gaussian_pyramid(images, params.pyramid)
        dg = dog_pyramid(gp)

    chunks = []
    for oct_idx, (gauss, dog) in enumerate(zip(gp.octaves, dg.octaves)):
        # Adaptive per-octave capacity: small octaves cannot produce
        # anywhere near the full budget.
        s_, h_, w_ = dog.shape[-3:]
        cap = min(params.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        oct_params = dataclasses.replace(params, dog=dataclasses.replace(
            params.dog, capacity=cap))
        out = _process_octave(gauss, dog, oct_params, gp.sigmas)
        trace.count("sift.desc_rows", out["desc"].shape[:-1].numel())
        trace.count(f"sift.valid.o{oct_idx}", out["mask"])
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

    with trace.span("sift.merge"):
        merged = Keypoints(*(torch.cat(parts, dim=1)
                             for parts in zip(*chunks)))

        # Keep the strongest total_capacity responses of each frame
        # (masked rows last).
        cap = params.total_capacity
        if merged.capacity <= cap:
            pad = cap - merged.capacity
            return Keypoints(*(torch.cat(
                [f, f.new_zeros((B, pad) + f.shape[2:])], dim=1)
                for f in merged))
        score = torch.where(merged.mask, merged.response.abs(),
                            torch.full_like(merged.response, float("-inf")))
        _, idx = chunked_top_k(score, cap)
        frames = torch.arange(B, device=dev)[:, None]
        return Keypoints(*(f[frames, idx] for f in merged))


def compute_sift_keypoints(image, params: SIFTParams = SIFTParams(),
                           device: str | torch.device | None = None
                           ) -> Keypoints:
    """SIFT keypoints + descriptors of a (H, W) float image.

    ``image`` is a numpy array or a tensor; it is moved to ``device``
    (None = the CUDA device; raises without one). Returns a fixed-capacity
    Keypoints (capacity = params.total_capacity) with positions in input
    image pixels and absolute sigmas, keeping the strongest responses across
    octaves. It is the B = 1 case of :func:`_compute_sift_batch`.
    """
    dev = resolve_device(device)
    image = torch.as_tensor(image).to(dev, torch.float32)
    kp = _compute_sift_batch(image[None], params, device=dev)
    return Keypoints(*(f[0] for f in kp))
