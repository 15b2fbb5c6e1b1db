"""Carry state over from the JAX package.

What a user carries over from ``sara_tpu`` is its Darknet parameters
(HWIO convolution weights become OIHW), its static configuration (SIFT,
matcher, bundle adjustment, odometry, loop-closure and global-SfM
settings), its keypoint sets, and its bundle-adjustment and pose-graph
problems. The converters
are duck-typed (``dataclasses.asdict`` or ``_asdict`` and the class name;
numpy arrays), so this module imports nothing of JAX or ``sara_tpu``.
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


def _sift_from_fields(fields: dict, twin: bool) -> SIFTParams:
    fields = dict(fields)
    if twin:
        # The twin reads low_precision only on a TPU; off a TPU it runs
        # the branch that the port's False selects.
        fields["low_precision"] = False
    fields["pyramid"] = PyramidParams(**fields["pyramid"])
    fields["dog"] = DoGParams(**fields["dog"])
    fields["desc_sampler"] = _SAMPLER[fields["desc_sampler"]]
    return SIFTParams(**fields)


def params_from_jax(obj):
    """The port's twin of a JAX ``SIFTParams``, ``DoGParams``,
    ``PyramidParams``, ``MatchParams``, ``BAOptions``, ``OdometryConfig``,
    ``LoopClosureConfig``, ``GlobalSfMConfig``, ``ChessboardParams``,
    ``LineSegmentParams``, ``CameraConfig`` or ``PipelineConfig`` (same
    field values, nested ones included; ``desc_sampler="pallas"`` becomes
    ``"kernel"``, and a JAX ``SIFTParams``'s ``low_precision``, which takes
    effect only on a TPU, becomes False)."""
    from sara_tpu_torch.calib.chessboard import ChessboardParams
    from sara_tpu_torch.config import CameraConfig, PipelineConfig
    from sara_tpu_torch.image.edge_chains import LineSegmentParams
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig
    from sara_tpu_torch.sfm.loop_closure import LoopClosureConfig
    from sara_tpu_torch.sfm.odometry import OdometryConfig

    name = type(obj).__name__
    if name == "BAOptions":
        return BAOptions(**obj._asdict())
    fields = dataclasses.asdict(obj)
    twin = type(obj).__module__.split(".")[0] == "sara_tpu"
    if name == "OdometryConfig":
        fields["sift"] = _sift_from_fields(fields["sift"], twin)
        fields["ba_options"] = params_from_jax(fields["ba_options"])
        return OdometryConfig(**fields)
    if name == "GlobalSfMConfig":
        fields["ba_options"] = params_from_jax(fields["ba_options"])
        return GlobalSfMConfig(**fields)
    if name == "LoopClosureConfig":
        return LoopClosureConfig(**fields)
    if name == "PyramidParams":
        return PyramidParams(**fields)
    if name == "DoGParams":
        return DoGParams(**fields)
    if name == "MatchParams":
        return MatchParams(**fields)
    if name == "SIFTParams":
        return _sift_from_fields(fields, twin)
    if name == "PipelineConfig":
        # asdict flattened the nested dataclasses; rebuild each from the
        # object's own attributes.
        return PipelineConfig(
            camera=CameraConfig(**fields["camera"]),
            pyramid=PyramidParams(**fields["pyramid"]),
            dog=DoGParams(**fields["dog"]),
            sift_max_orientations=obj.sift_max_orientations,
            sift_total_capacity=obj.sift_total_capacity,
            match_ratio=obj.match_ratio,
            odometry=params_from_jax(obj.odometry),
            ba=params_from_jax(obj.ba))
    simple = {"ChessboardParams": ChessboardParams,
              "LineSegmentParams": LineSegmentParams,
              "CameraConfig": CameraConfig}
    if name in simple:
        return simple[name](**fields)
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


def pose_graph_problem_from_numpy(fields,
                                  device: str | torch.device | None = None,
                                  dtype: torch.dtype | None = None):
    """The port's PoseGraphProblem from a JAX ``PoseGraphProblem`` or any
    sequence of its seven fields (poses, edge_i, edge_j, rel_pose, weight,
    edge_mask, pose_fixed) as arrays, on ``device`` (None = the CUDA
    device). The float fields take ``dtype`` when given, else keep their
    own; index and mask arrays keep theirs."""
    from sara_tpu_torch.sfm.pose_graph_opt import PoseGraphProblem

    dev = resolve_device(device)
    arrays = [np.array(a) for a in fields]
    if len(arrays) != len(PoseGraphProblem._fields):
        raise ValueError(f"expected {len(PoseGraphProblem._fields)} fields, "
                         f"got {len(arrays)}")
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if dtype is not None and t.dtype.is_floating_point:
            t = t.to(dtype)
        out.append(t.to(dev))
    return PoseGraphProblem(*out)


def darknet_params_from_jax(params, device: str | torch.device | None = None):
    """The port's Darknet parameter list from the JAX package's (one dict
    of arrays per layer, None for layers without weights; convolution
    weights HWIO): the same values, convolution weights OIHW, float32
    tensors on ``device`` (None = the CUDA device)."""
    from sara_tpu_torch.nn.darknet import _conv_weight

    dev = resolve_device(device)
    out = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        q = {k: torch.as_tensor(np.array(v, np.float32)).to(dev)
             for k, v in p.items() if k != "w"}
        q["w"] = _conv_weight(np.asarray(p["w"], np.float32)
                              .transpose(3, 2, 0, 1), dev)
        out.append(q)
    return out
