"""Plain mutual ratio-test matching of two descriptor sets.

The reference for the port's brute-force matcher: squared L2 distances
||a||^2 + ||b||^2 - 2 a.b from one float32 product (clamped at 0), padded
keypoints at +inf, the nearest and second-nearest neighbour of each row,
Lowe's ratio 0.8 on distances (0.64 on squared distances), and the mutual
check that the nearest row of the chosen column is the row itself.
"""

from __future__ import annotations

import torch

RATIO = 0.8


def match(da, ma, db, mb, ratio: float = RATIO):
    """(j (Na,) int64, ok (Na,) bool, d1 (Na,) the best squared distance)
    of sets da (Na, D) with mask ma against db (Nb, D) with mask mb."""
    d2 = ((da * da).sum(-1)[:, None] + (db * db).sum(-1)[None, :]
          - 2.0 * da @ db.T).clamp(min=0.0)
    d2 = torch.where(ma[:, None] & mb[None, :], d2,
                     torch.full_like(d2, float("inf")))
    best = d2.min(dim=1)
    j = best.indices
    second = d2.scatter(1, j[:, None], float("inf")).min(dim=1).values
    ok = (best.values < ratio * ratio * second) & ma & torch.isfinite(
        best.values)
    back = d2.argmin(dim=0)
    ok = ok & (back[j] == torch.arange(da.shape[0], device=da.device))
    return j, ok, best.values
