"""Self-matching with spatial exclusion (KeyProximity).

Twin of ``sara_tpu/matching/key_proximity.py`` (reference:
cpp/src/DO/Sara/FeatureMatching/KeyProximity.hpp + AnnMatcher
self-matching mode): match a keypoint set against itself while excluding
neighbors that are spatially close or overlapping in scale-space — finds
repeated structure within one image. Runs on the keypoints' device.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.core.types import Keypoints, Matches
from sara_tpu_torch.matching.brute_force import _top2_min


def self_match(kp: Keypoints, min_pixel_dist: float = 10.0,
               scale_ratio_max: float = 2.0, ratio: float = 0.8) -> Matches:
    """Match kp against itself, excluding spatial neighbors."""
    d = kp.descriptors
    na = torch.sum(d * d, dim=-1, keepdim=True)
    d2 = torch.clamp(na + na.T - 2.0 * d @ d.T, min=0.0)

    # Exclusion: same index, spatial proximity, or similar position in
    # scale space (reference KeyProximity uses both pixel and scale gates).
    pix = torch.linalg.vector_norm(kp.xy[:, None] - kp.xy[None], dim=-1)
    sr = kp.scale[:, None] / torch.clamp(kp.scale[None], min=1e-9)
    sr = torch.maximum(sr, 1.0 / torch.clamp(sr, min=1e-9))
    near = (pix < min_pixel_dist) & (sr < scale_ratio_max)
    eye = torch.eye(kp.capacity, dtype=torch.bool, device=d.device)
    invalid = near | eye | ~(kp.mask[:, None] & kp.mask[None])
    d2 = torch.where(invalid, torch.full_like(d2, float("inf")), d2)

    # The best two per row (the twin's top_k of -d2, k = 2).
    d1, d2nd, j = _top2_min(d2)
    ok = (d1 < ratio * ratio * d2nd) & kp.mask & torch.isfinite(d1)
    return Matches(i=torch.arange(kp.capacity, dtype=torch.int32,
                                  device=d.device),
                   j=j.to(torch.int32), score=d1, mask=ok)
