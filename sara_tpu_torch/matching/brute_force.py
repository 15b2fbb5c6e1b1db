"""Brute-force descriptor matching: GEMM distances + Lowe ratio test.

Twin of ``sara_tpu/matching/brute_force.py``:

    ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b

as one (capacity x capacity) float32 matrix product, the best two per row,
the ratio test and a mutual-consistency check. Masked (padded) keypoints
get +inf distance. The reference runs the product in bf16 only on a TPU;
the port keeps float32 (TF32 is pinned off in the package's ``__init__``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.core.types import Keypoints, Matches
from sara_tpu_torch.utils.timing import trace


@dataclass(frozen=True)
class MatchParams:
    """Static matcher knobs.

    ratio: Lowe ratio on *distances* (the SfM pipeline uses 0.8).
    mutual: require best-match consistency in both directions.
    """

    ratio: float = 0.8
    mutual: bool = True


def _pairwise_sqdist(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(..., Na, D) x (..., Nb, D) -> (..., Na, Nb) squared L2 distances
    via one (batched) GEMM."""
    na = (da * da).sum(dim=-1, keepdim=True)
    nb = (db * db).sum(dim=-1, keepdim=True)
    d2 = na + nb.transpose(-1, -2) - 2.0 * torch.matmul(
        da, db.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def _top2_min(d2: torch.Tensor):
    """Row-wise (best, second-best, argbest) by two min passes."""
    j = torch.argmin(d2, dim=-1)
    d1 = torch.gather(d2, -1, j[..., None])[..., 0]
    masked = d2.scatter(-1, j[..., None], float("inf"))
    d2nd = masked.amin(dim=-1)
    return d1, d2nd, j


def _match_sets(da, ma, db, mb, ratio: float, mutual: bool = True):
    """Mutual ratio-test matching of descriptor sets da (..., Na, D) with
    masks ma (..., Na) against db, mb; leading dims are independent pairs.
    Returns (j (..., Na) int64, ok (..., Na) bool, d1 (..., Na)).

    Under a ``torch.profiler`` session it records the span ``match``
    (units: pairs) and the counters ``match.cells`` (distance cells
    computed, Na·Nb per pair) and ``match.cells_valid`` (those between
    two kept keypoints), see ``utils/timing.py::trace``."""
    pairs = ma.shape[:-1].numel()
    with trace.span("match", pairs):
        trace.count("match.cells", pairs * ma.shape[-1] * mb.shape[-1])
        trace.count("match.cells_valid",
                    lambda: ma.sum(-1) * mb.sum(-1))
        d2 = _pairwise_sqdist(da, db)
        d2 = torch.where(ma[..., :, None] & mb[..., None, :], d2,
                         torch.full_like(d2, float("inf")))
        d1, d2nd, j = _top2_min(d2)
        # Lowe ratio on squared distances: d1 < ratio^2 * d2nd.
        ok = (d1 < (ratio ** 2) * d2nd) & ma & torch.isfinite(d1)
        if mutual:
            jT = torch.argmin(d2, dim=-2)  # best a-index for each b-index
            rows = torch.arange(da.shape[-2], device=da.device)
            ok = ok & (torch.gather(jT, -1, j) == rows)
    return j, ok, d1


def match_descriptors(a: Keypoints, b: Keypoints,
                      params: MatchParams = MatchParams(),
                      device: str | torch.device | None = None) -> Matches:
    """Match keypoint sets a -> b. Output capacity = a.capacity.

    Both sets are moved to ``device`` (None = the CUDA device; raises
    without one).
    """
    dev = resolve_device(device)
    a = Keypoints(*(f.to(dev) for f in a))
    b = Keypoints(*(f.to(dev) for f in b))
    j, ok, d1 = _match_sets(a.descriptors, a.mask, b.descriptors, b.mask,
                            params.ratio, params.mutual)
    rows = torch.arange(a.capacity, device=dev)
    return Matches(i=rows.to(torch.int32), j=j.to(torch.int32), score=d1,
                   mask=ok)
