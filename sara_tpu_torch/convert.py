"""Carry state over from the JAX package.

The port has no learned weights; what a user carries over from
``sara_tpu`` is its static configuration (SIFT, matcher, bundle adjustment
and odometry settings), its keypoint sets and its bundle-adjustment
problems. The converters are duck-typed (``dataclasses.asdict`` or
``_asdict`` and the class name; numpy arrays), so this module imports
nothing of JAX or ``sara_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.ba.core import BAOptions, BAProblem
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.features.api import SIFTParams
from sara_tpu_torch.features.dog import DoGParams
from sara_tpu_torch.image.pyramid import PyramidParams
from sara_tpu_torch.matching.brute_force import MatchParams

# Sampler names -> the port's (the port's own map onto themselves).
_SAMPLER = {"pallas": "kernel", "kernel": "kernel", "gather": "gather",
            "auto": "auto"}


def _sift_from_fields(fields: dict) -> SIFTParams:
    fields = dict(fields)
    fields["pyramid"] = PyramidParams(**fields["pyramid"])
    fields["dog"] = DoGParams(**fields["dog"])
    fields["desc_sampler"] = _SAMPLER[fields["desc_sampler"]]
    return SIFTParams(**fields)


def params_from_jax(obj):
    """The port's twin of a JAX ``SIFTParams``, ``DoGParams``,
    ``PyramidParams``, ``MatchParams``, ``BAOptions`` or
    ``OdometryConfig`` (same field values, nested ones included;
    ``desc_sampler="pallas"`` becomes ``"kernel"``)."""
    from sara_tpu_torch.sfm.odometry import OdometryConfig

    name = type(obj).__name__
    if name == "BAOptions":
        return BAOptions(**obj._asdict())
    fields = dataclasses.asdict(obj)
    if name == "OdometryConfig":
        fields["sift"] = _sift_from_fields(fields["sift"])
        fields["ba_options"] = params_from_jax(fields["ba_options"])
        return OdometryConfig(**fields)
    if name == "PyramidParams":
        return PyramidParams(**fields)
    if name == "DoGParams":
        return DoGParams(**fields)
    if name == "MatchParams":
        return MatchParams(**fields)
    if name == "SIFTParams":
        return _sift_from_fields(fields)
    raise TypeError(f"no port twin for {name}")


def keypoints_from_numpy(fields, device: str | torch.device | None = None
                         ) -> Keypoints:
    """The port's Keypoints from a JAX ``Keypoints`` or any sequence of its
    six fields (xy, scale, orientation, response, descriptors, mask) as
    arrays, on ``device`` (None = the CUDA device)."""
    dev = resolve_device(device)
    arrays = [np.asarray(f) for f in fields]
    if len(arrays) != len(Keypoints._fields):
        raise ValueError(f"expected {len(Keypoints._fields)} fields, got "
                         f"{len(arrays)}")
    *floats, mask = arrays
    return Keypoints(*(torch.as_tensor(a.astype(np.float32)).to(dev)
                       for a in floats),
                     mask=torch.as_tensor(mask.astype(bool)).to(dev))


def ba_problem_from_numpy(fields, device: str | torch.device | None = None
                          ) -> BAProblem:
    """The port's BAProblem from a JAX ``BAProblem`` or any sequence of its
    fields (poses, points, intrinsics, cam_idx, pt_idx, uv, obs_mask,
    pose_fixed, point_fixed[, intr_free]) as arrays, on ``device`` (None =
    the CUDA device). Every array keeps its dtype; a missing or None
    ``intr_free`` stays None."""
    dev = resolve_device(device)
    arrays = list(fields)
    if len(arrays) not in (len(BAProblem._fields) - 1,
                           len(BAProblem._fields)):
        raise ValueError(f"expected {len(BAProblem._fields)} fields, got "
                         f"{len(arrays)}")
    return BAProblem(*(None if a is None
                       else torch.as_tensor(np.array(a)).to(dev)
                       for a in arrays))
