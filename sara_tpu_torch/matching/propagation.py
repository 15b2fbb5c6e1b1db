"""Match propagation — seed-and-grow densification of putative matches.

Twin of ``sara_tpu/matching/propagation.py`` (reference:
cpp/drafts/MatchPropagation/cpp/src/GrowRegion.hpp:40-80,
MatchNeighborhood.hpp:35-60 ``AffineCovariantMatchDistance``,
GrowMultipleRegions.hpp, LocalAffineConsistency.hpp — the ACCV 2012
"Efficient and Scalable 4th-order Match Propagation" algorithm).

The reference grows regions one match at a time with KD-tree
neighbourhoods and a priority queue; the twin, and this port, grow all
seeds at once as boolean frontier expansion on a match-consistency matrix:

1. one (M, M) pairwise consistency matrix C: match n supports match m when
   it lies in m's affine-covariant neighborhood (distances measured in the
   keypoints' shape metric, as the reference's rho_m) with a symmetric
   scale ratio above ``rho_min`` and compatible relative orientation;
2. regions for all S seeds grow *simultaneously* by a fixed-iteration
   vote sweep, ``region @ C`` (one float32 (S, M) x (M, M) product per
   sweep): a match joins region R when >= ``min_votes`` current members
   support it;
3. each grown region is verified by a closed-form least-squares affinity
   fit over its members (batched over seeds, ``solve_ex``, no host read);
   members whose affine transfer error exceeds ``delta_x`` pixels are
   dropped.

Everything is fixed-shape: M = match capacity, S = seed count, matrices
instead of graphs, masks instead of sets. Runs on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sara_tpu_torch.core.types import Keypoints, Matches


class PropagationParams(NamedTuple):
    """Knobs for region growing (reference: GrowthParams.hpp PredParams).

    neighborhood_radius: neighborhood size in units of the source keypoint
      scale (the reference uses K=80 KD-tree neighbors; a metric radius is
      the fixed-shape analog).
    rho_min: minimum affine-covariant distance ratio min(dx,dy)/max(dx,dy)
      (reference: squared_rho_min in PredParams, rho_m in
      MatchNeighborhood.hpp:35-60).
    delta_theta: max deviation (radians) between the relative-orientation
      change of the two matches (reference: PredParams delta_theta).
    delta_x: max affine transfer error in pixels for the final per-region
      affinity verification (reference: PredParams delta_x).
    min_votes: members that must support a candidate before it joins —
      the batched stand-in for the affine-consistent triple test.
    num_iters: frontier-expansion sweeps (region diameter bound).
    """

    neighborhood_radius: float = 12.0
    rho_min: float = 0.3
    delta_theta: float = 0.7
    delta_x: float = 12.0
    min_votes: int = 3
    num_iters: int = 10


def match_consistency_matrix(kp_a: Keypoints, kp_b: Keypoints,
                             matches: Matches,
                             params: PropagationParams = PropagationParams()
                             ) -> torch.Tensor:
    """(M, M) bool: C[m, n] — does match n support match m?

    Support requires (all measured in the affine-covariant metric of the
    reference's ``AffineCovariantMatchDistance``, with SIFT's circular
    shape matrix Sigma = I / scale^2):
      - n lies within ``neighborhood_radius`` of m on the source side;
      - the source/target covariant distances agree:
        min(dx, dy) / max(dx, dy) >= rho_min;
      - the displacement directions rotate consistently with the
        keypoints' orientation change (within delta_theta);
      - m and n share no endpoint (one-to-one matching).
    The (M, M, 2) displacements of the twin are kept as their two (M, M)
    components (the same sums).
    """
    i, j = matches.i.long(), matches.j.long()
    xm = kp_a.xy[i]                    # (M, 2)
    ym = kp_b.xy[j]
    sx = torch.clamp(kp_a.scale[i], min=1e-6)
    sy = torch.clamp(kp_b.scale[j], min=1e-6)

    # Source / target displacements m -> n, one (M, M) map per component.
    dx0 = xm[None, :, 0] - xm[:, None, 0]
    dx1 = xm[None, :, 1] - xm[:, None, 1]
    dy0 = ym[None, :, 0] - ym[:, None, 0]
    dy1 = ym[None, :, 1] - ym[:, None, 1]
    # Covariant squared distances in m's shape metric (rho_m numerator terms).
    dxx = (dx0 * dx0 + dx1 * dx1) / (sx[:, None] ** 2)
    dyy = (dy0 * dy0 + dy1 * dy1) / (sy[:, None] ** 2)

    near = dxx <= params.neighborhood_radius ** 2
    lo = torch.minimum(dxx, dyy)
    hi = torch.maximum(dxx, dyy)
    rho_ok = lo >= params.rho_min * hi  # rho = lo/hi >= rho_min, 0/0-safe

    # Relative-orientation consistency: the angle of the displacement must
    # rotate by the same amount on both sides as the keypoint orientation
    # change of m (LocalAffineConsistency angle_difference_in_radian).
    dtheta = (kp_b.orientation[j] - kp_a.orientation[i])[:, None]
    dang = torch.atan2(dy1, dy0) - torch.atan2(dx1, dx0) - dtheta
    dang = torch.atan2(torch.sin(dang), torch.cos(dang))
    ang_ok = dang.abs() <= params.delta_theta

    distinct = ((matches.i[:, None] != matches.i[None, :])
                & (matches.j[:, None] != matches.j[None, :]))
    valid = matches.mask[:, None] & matches.mask[None, :]
    return near & rho_ok & ang_ok & distinct & valid


def _fit_affinity(x: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares 2x3 affinities mapping x -> y, one per row of
    weights ``w`` (S, M): (S, 2, 3).

    Closed-form generalization of the reference's 3-point
    ``affinity_from_x_to_y`` (LocalAffineConsistency.hpp:38) to all region
    members; normal equations on homogeneous source coordinates.
    """
    xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)       # (M, 3)
    wx = xh[None] * w[:, :, None]                               # (S, M, 3)
    ata = (xh.T @ wx
           + 1e-6 * torch.eye(3, dtype=x.dtype, device=x.device))
    atb = wx.transpose(1, 2) @ y                                # (S, 3, 2)
    return torch.linalg.solve_ex(ata, atb).result.transpose(1, 2)


def _seeds(matches: Matches, num_seeds: int) -> torch.Tensor:
    """The seed matches: the lowest descriptor distances (scores are
    squared L2; the reference grows from best matches first,
    GrowMultipleRegions), equal scores in index order as ``lax.top_k``
    orders them (a stable sort; ``torch.topk`` orders ties arbitrarily,
    and a frame pair holds many equal distances)."""
    score = torch.where(matches.mask, matches.score,
                        torch.full_like(matches.score, float("inf")))
    return torch.sort(score, stable=True).indices[:num_seeds]


def _grow(region: torch.Tensor, C: torch.Tensor,
          params: PropagationParams) -> torch.Tensor:
    """``num_iters`` vote sweeps of the (S, M) float regions over the
    mutual consistency matrix C (M, M) float32."""
    for t in range(params.num_iters):
        votes = region @ C  # (S, M): region members supporting candidate n
        # Vote threshold ramps 1, 2, ..., min_votes: a lone seed first pulls
        # its direct supporters (the reference's affine-quadruple
        # initialization, GrowRegion.hpp initialize_affine_quadruple), then
        # growth requires the full quorum.
        need = float(min(t + 1, params.min_votes))
        region = ((votes >= need) | (region > 0.5)).to(torch.float32)
    return region


def propagate_matches(kp_a: Keypoints, kp_b: Keypoints, matches: Matches,
                      num_seeds: int = 32,
                      params: PropagationParams = PropagationParams()):
    """Grow affine-consistent regions from the best-scoring seed matches.

    Batched analog of GrowMultipleRegions: all seeds grow at once via
    ``num_iters`` vote sweeps over the consistency matrix, then each region
    is verified with a least-squares affinity and trimmed at ``delta_x``.

    Returns (region_members (S, M) bool, labels (M,) int32, densified mask
    (M,) bool). ``labels[m]`` is the first region containing match m, or -1;
    the densified mask is the union of verified regions — the propagated
    (outlier-resistant) match set.
    """
    C = match_consistency_matrix(kp_a, kp_b, matches, params)
    # Mutual support only (both matches lie in each other's covariant
    # neighborhood) — the strict form of the reference's pairwise check.
    C = (C & C.T).to(torch.float32)

    region = torch.nn.functional.one_hot(
        _seeds(matches, num_seeds), matches.capacity).to(torch.float32)
    members = _grow(region, C, params) > 0.5                  # (S, M)

    # Per-region affinity verification (batched over seeds).
    xm = kp_a.xy[matches.i.long()]
    ym = kp_b.xy[matches.j.long()]
    A = _fit_affinity(xm, ym, members.to(torch.float32))      # (S, 2, 3)
    xh = torch.cat([xm, torch.ones_like(xm[:, :1])], dim=1)
    err = torch.linalg.vector_norm(xh @ A.transpose(1, 2) - ym, dim=-1)
    keep = members & (err <= params.delta_x)
    # A region needs >= 4 verified members to define an affinity at all
    # (the reference's affine quadruple initialization, GrowRegion.hpp).
    members = keep & (keep.sum(dim=1, keepdim=True) >= 4)

    densified = torch.any(members, dim=0) & matches.mask
    first_region = torch.argmax(members.to(torch.uint8), dim=0)
    labels = torch.where(densified, first_region.to(torch.int32),
                         torch.full_like(first_region, -1, dtype=torch.int32))
    return members, labels, densified
