"""Carry state over from the JAX package.

The SIFT frontend and matcher have no learned weights; what a user carries
over from ``sara_tpu`` is its static configuration and its keypoint sets.
Both converters are duck-typed (``dataclasses.asdict`` and the class name;
numpy arrays), so this module imports nothing of JAX or ``sara_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints
from sara_tpu_torch.features.api import SIFTParams
from sara_tpu_torch.features.dog import DoGParams
from sara_tpu_torch.image.pyramid import PyramidParams
from sara_tpu_torch.matching.brute_force import MatchParams

# Sampler names -> the port's (the port's own map onto themselves).
_SAMPLER = {"pallas": "kernel", "kernel": "kernel", "gather": "gather",
            "auto": "auto"}


def params_from_jax(obj):
    """The port's twin of a JAX ``SIFTParams``, ``DoGParams``,
    ``PyramidParams`` or ``MatchParams`` (same field values;
    ``desc_sampler="pallas"`` becomes ``"kernel"``)."""
    name = type(obj).__name__
    fields = dataclasses.asdict(obj)
    if name == "PyramidParams":
        return PyramidParams(**fields)
    if name == "DoGParams":
        return DoGParams(**fields)
    if name == "MatchParams":
        return MatchParams(**fields)
    if name == "SIFTParams":
        fields["pyramid"] = PyramidParams(**fields["pyramid"])
        fields["dog"] = DoGParams(**fields["dog"])
        fields["desc_sampler"] = _SAMPLER[fields["desc_sampler"]]
        return SIFTParams(**fields)
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
