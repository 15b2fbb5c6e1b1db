"""Normalized cross-correlation patch matching.

Twin of ``sara_tpu/matching/ncc.py`` (reference:
cpp/src/DO/Sara/FeatureMatching/NCC.hpp): patches around keypoints are
zero-mean / unit-norm normalized and correlated as one float32 matrix
product, the dense analog of the descriptor matcher.
"""

from __future__ import annotations

import torch

from sara_tpu_torch import resolve_device


def extract_patches(image: torch.Tensor, xy: torch.Tensor, radius: int):
    """Gather (2r+1)^2 patches at integer-rounded centers; returns
    (K, P*P) rows plus an inside-image mask."""
    H, W = image.shape
    xc = torch.round(xy[:, 0]).long()
    yc = torch.round(xy[:, 1]).long()
    offs = torch.arange(-radius, radius + 1, device=image.device)
    yy = yc[:, None] + offs
    xx = xc[:, None] + offs
    inside = (((yy >= 0) & (yy < H)).all(dim=1)
              & ((xx >= 0) & (xx < W)).all(dim=1))
    patch = image[torch.clamp(yy, 0, H - 1)[:, :, None],
                  torch.clamp(xx, 0, W - 1)[:, None, :]]
    return patch.reshape(patch.shape[0], -1), inside


def normalize_rows(p: torch.Tensor) -> torch.Tensor:
    p = p - torch.mean(p, dim=-1, keepdim=True)
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True),
                           min=1e-8)


def ncc_match(image_a, xy_a, mask_a, image_b, xy_b, mask_b,
              radius: int = 7, min_score: float = 0.7,
              device: str | torch.device | None = None):
    """Match keypoints by best NCC score with mutual consistency, on
    ``device`` (None: the card; the inputs go there).

    Returns (j (Ka,) int32, score (Ka,), ok (Ka,)).
    """
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a).to(dev, torch.float32)
    on = lambda m: torch.as_tensor(m).to(dev, torch.bool)
    pa, ia = extract_patches(f32(image_a), f32(xy_a), radius)
    pb, ib = extract_patches(f32(image_b), f32(xy_b), radius)
    corr = normalize_rows(pa) @ normalize_rows(pb).T   # (Ka, Kb)
    va = on(mask_a) & ia
    vb = on(mask_b) & ib
    corr = torch.where(va[:, None] & vb[None, :], corr,
                       torch.full_like(corr, float("-inf")))
    s, j = torch.max(corr, dim=1)        # first maximum, like jnp.argmax
    jT = torch.argmax(corr, dim=0)
    ok = (va & (s >= min_score)
          & (jT[j] == torch.arange(corr.shape[0], device=dev)))
    return j.to(torch.int32), s, ok
