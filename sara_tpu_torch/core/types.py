"""Fixed-capacity keypoint / match containers.

Twin of ``sara_tpu/core/types.py``: NamedTuples of tensors with a leading
capacity dimension and a boolean validity ``mask``; the actual count is
``mask.sum()``. A batch of sets (the frames of a window) carries a frame
axis before the slot axis: ``capacity`` reads the slot axis and ``count()``
counts per set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sara_tpu_torch import resolve_device


class Keypoints(NamedTuple):
    """A fixed-capacity set of oriented scale-space keypoints.

    Attributes:
      xy:          (N, 2) float32 — (x, y) pixel position at full image scale.
      scale:       (N,)  float32 — characteristic scale sigma (pixels).
      orientation: (N,)  float32 — dominant orientation in radians.
      response:    (N,)  float32 — extremum value.
      descriptors: (N, D) float32 — descriptor rows (D=128 for SIFT).
      mask:        (N,)  bool — True for valid rows.
    """

    xy: torch.Tensor
    scale: torch.Tensor
    orientation: torch.Tensor
    response: torch.Tensor
    descriptors: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        """Slots per set (the slot axis of ``xy``, (..., N, 2))."""
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        """Valid keypoints per set: a scalar, or (B,) for a batch."""
        return self.mask.sum(dim=-1)

    @staticmethod
    def empty(capacity: int, descriptor_dim: int = 128,
              device: str | torch.device | None = None) -> "Keypoints":
        """An empty set on ``device`` (None: the card, or raise)."""
        device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        return Keypoints(
            xy=torch.zeros((capacity, 2), **f32),
            scale=torch.zeros((capacity,), **f32),
            orientation=torch.zeros((capacity,), **f32),
            response=torch.zeros((capacity,), **f32),
            descriptors=torch.zeros((capacity, descriptor_dim), **f32),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class Matches(NamedTuple):
    """Fixed-capacity descriptor matches between two keypoint sets.

    Attributes:
      i:     (M,) int32 — index into the source keypoint set.
      j:     (M,) int32 — index into the target keypoint set.
      score: (M,) float32 — squared descriptor distance.
      mask:  (M,) bool.
    """

    i: torch.Tensor
    j: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        """Slots per set (the last axis of ``i``)."""
        return self.i.shape[-1]

    def count(self) -> torch.Tensor:
        """Valid matches per set: a scalar, or (B,) for a batch."""
        return self.mask.sum(dim=-1)

    @staticmethod
    def empty(capacity: int,
              device: str | torch.device | None = None) -> "Matches":
        """An empty set on ``device`` (None: the card, or raise)."""
        device = resolve_device(device)
        return Matches(
            i=torch.zeros((capacity,), dtype=torch.int32, device=device),
            j=torch.zeros((capacity,), dtype=torch.int32, device=device),
            score=torch.zeros((capacity,), dtype=torch.float32,
                              device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


def concat_keypoints(a: Keypoints, b: Keypoints) -> Keypoints:
    """Concatenate two keypoint sets (capacity adds; masks preserved)."""
    return Keypoints(*(torch.cat([fa, fb], dim=0) for fa, fb in zip(a, b)))


def take_keypoints(k: Keypoints, idx: torch.Tensor,
                   valid: torch.Tensor) -> Keypoints:
    """Gather rows ``idx`` from ``k``; rows where ``valid`` is False are
    masked."""
    idx = idx.long()
    return Keypoints(
        xy=k.xy[idx],
        scale=k.scale[idx],
        orientation=k.orientation[idx],
        response=k.response[idx],
        descriptors=k.descriptors[idx],
        mask=k.mask[idx] & valid,
    )
