"""Unified typed configuration (twin of ``sara_tpu/config.py``).

One dataclass tree covering the full pipeline, built on the port's
``BAOptions``, ``SIFTParams``, ``DoGParams``, ``PyramidParams``,
``MatchParams`` and ``OdometryConfig``; a JSON round trip for experiment
tracking; converters to the per-stage parameter objects. The JSON has the
twin's layout, so either package reads the other's file (the port's
``SIFTParams`` adds nothing; its ``low_precision`` default is False).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from sara_tpu_torch.ba.core import BAOptions
from sara_tpu_torch.features.api import SIFTParams
from sara_tpu_torch.features.dog import DoGParams
from sara_tpu_torch.image.pyramid import PyramidParams
from sara_tpu_torch.matching.brute_force import MatchParams
from sara_tpu_torch.sfm.odometry import OdometryConfig


def _ba_options(v) -> BAOptions:
    """``BAOptions`` from its JSON: ``to_json`` writes the NamedTuple as a
    list of its fields, as the twin's does, which the twin's ``from_json``
    leaves a list; the port reads that list, or a dict of fields, back
    into ``BAOptions``."""
    return BAOptions(*v) if isinstance(v, list) else BAOptions(**v)


@dataclass(frozen=True)
class CameraConfig:
    fx: float = 800.0
    fy: float = 800.0
    cx: float = 640.0
    cy: float = 360.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def K(self):
        import numpy as np

        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1.0]])

    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.k3,
                                        self.p1, self.p2))


@dataclass(frozen=True)
class PipelineConfig:
    """Everything the SfM/VO pipeline needs, in one place."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    pyramid: PyramidParams = field(default_factory=PyramidParams)
    dog: DoGParams = field(default_factory=DoGParams)
    sift_max_orientations: int = 2
    sift_total_capacity: int = 4096
    match_ratio: float = 0.8
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    ba: BAOptions = field(default_factory=BAOptions)

    def sift_params(self) -> SIFTParams:
        return SIFTParams(pyramid=self.pyramid, dog=self.dog,
                          max_orientations=self.sift_max_orientations,
                          total_capacity=self.sift_total_capacity)

    def match_params(self) -> MatchParams:
        return MatchParams(ratio=self.match_ratio)

    # -- serialization -----------------------------------------------------

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {f.name: enc(getattr(o, f.name))
                        for f in dataclasses.fields(o)}
            if isinstance(o, tuple):     # BAOptions too: a list of fields
                return list(o)
            return o

        return json.dumps(enc(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        raw = json.loads(text)

        def build(cls, d):
            if cls is BAOptions:
                return _ba_options(d)
            sub_types = {"camera": CameraConfig, "pyramid": PyramidParams,
                         "dog": DoGParams, "ba": BAOptions}
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                sub = sub_types.get(f.name)
                if sub is not None and isinstance(v, (dict, list)):
                    v = build(sub, v)
                kwargs[f.name] = v
            return cls(**kwargs)

        # OdometryConfig nests SIFTParams/BAOptions; rebuild those first.
        od = raw.get("odometry", {})
        if isinstance(od, dict):
            od = dict(od)
            if "sift" in od and isinstance(od["sift"], dict):
                s = dict(od["sift"])
                if isinstance(s.get("pyramid"), dict):
                    s["pyramid"] = PyramidParams(**s["pyramid"])
                if isinstance(s.get("dog"), dict):
                    s["dog"] = DoGParams(**s["dog"])
                od["sift"] = SIFTParams(**s)
            if "ba_options" in od and isinstance(od["ba_options"],
                                                 (dict, list)):
                od["ba_options"] = _ba_options(od["ba_options"])
            raw["odometry"] = OdometryConfig(**od)
        return build(PipelineConfig, raw)
