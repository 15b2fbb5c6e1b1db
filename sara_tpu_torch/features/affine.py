"""Affine shape adaptation of keypoints.

Twin of ``sara_tpu/features/affine.py`` (reference:
cpp/src/DO/Sara/FeatureDetectors/AffineShapeAdaptation.hpp:43
``AdaptFeatureAffinelyToLocalShape`` — iteratively estimate the second-moment
matrix in the keypoint's normalized frame until isotropy). A fixed number
of iterations over all keypoints at once (the twin vmaps a ``fori_loop``);
the 2x2 symmetric eigen-decompositions, determinants and inverses are in
closed form, so the loop never reads the device (``torch.linalg.eigh``
checks its result on the host).
"""

from __future__ import annotations

import torch

from sara_tpu_torch import resolve_device
from sara_tpu_torch.image.filtering import gaussian_blur


def _det2(M: torch.Tensor) -> torch.Tensor:
    return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]


def _eigh2(a, b, c):
    """Eigenvalues (ascending) and the rotation angle of the eigenvectors
    of the symmetric 2x2 matrices [[a, b], [b, c]]."""
    m = 0.5 * (a + c)
    r = torch.hypot(0.5 * (a - c), b)
    return m - r, m + r, 0.5 * torch.atan2(2.0 * b, a - c)


def _mat2(m00, m01, m10, m11) -> torch.Tensor:
    return torch.stack([torch.stack([m00, m01], -1),
                        torch.stack([m10, m11], -1)], -2)


def adapt_affine_shapes(image: torch.Tensor, xy: torch.Tensor,
                        scale: torch.Tensor, mask: torch.Tensor,
                        iters: int = 5, patch_radius: int = 16,
                        device: str | torch.device | None = None):
    """Estimate a 2x2 shape matrix per keypoint, on ``device`` (None: the
    card; the inputs go there).

    Returns (shape (K, 2, 2) with unit determinant, converged (K,)).
    The shape matrix M satisfies: the keypoint's neighborhood is isotropic
    under the whitening transform M^{-1/2} (reference semantics: OERegion
    shape_matrix, Features/Feature.hpp:40).
    """
    dev = resolve_device(device)
    image = torch.as_tensor(image).to(dev, torch.float32)
    xy = torch.as_tensor(xy).to(dev, torch.float32)
    scale = torch.as_tensor(scale).to(dev, torch.float32)
    mask = torch.as_tensor(mask).to(dev, torch.bool)
    H, W = image.shape
    K = xy.shape[0]
    sm = gaussian_blur(image, 1.0)
    # Gradients once, with the twin's wrap-around (roll) differences.
    gx = 0.5 * (torch.roll(sm, -1, 1) - torch.roll(sm, 1, 1))
    gy = 0.5 * (torch.roll(sm, -1, 0) - torch.roll(sm, 1, 0))
    g = torch.stack([gx, gy], dim=-1).reshape(H * W, 2)

    offs = torch.arange(-patch_radius, patch_radius + 1, dtype=torch.float32,
                        device=dev)
    vv, uu = torch.meshgrid(offs, offs, indexing="ij")   # uu = column
    w_g = torch.exp(-(uu ** 2 + vv ** 2) / (2.0 * (patch_radius / 2.0) ** 2))

    def bilin(ys, xs):
        """Both gradient maps at (ys, xs), bilinear, clamped to the image:
        (..., 2)."""
        ysc = torch.clamp(ys, 0.0, H - 1.0)
        xsc = torch.clamp(xs, 0.0, W - 1.0)
        y0 = torch.floor(ysc).long()
        x0 = torch.floor(xsc).long()
        y1 = torch.clamp(y0 + 1, max=H - 1)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        fy = (ysc - y0)[..., None]
        fx = (xsc - x0)[..., None]
        return (g[y0 * W + x0] * (1 - fx) * (1 - fy)
                + g[y0 * W + x1] * fx * (1 - fy)
                + g[y1 * W + x0] * (1 - fx) * fy
                + g[y1 * W + x1] * fx * fy)

    s = (scale / patch_radius * 3.0)[:, None, None]
    A = torch.eye(2, dtype=torch.float32, device=dev).expand(K, 2, 2)
    for _ in range(iters):
        # Sample the patch in the whitened frame: p = xy + A (s u, s v).
        a = lambda i, j: A[:, i, j, None, None]
        du = a(0, 0) * uu + a(0, 1) * vv
        dv = a(1, 0) * uu + a(1, 1) * vv
        gs = bilin(xy[:, 1, None, None] + s * dv,
                   xy[:, 0, None, None] + s * du)
        gxs, gys = gs[..., 0], gs[..., 1]
        # Rotate gradients into the whitened frame: g' = A^T g.
        gu = a(0, 0) * gxs + a(1, 0) * gys
        gv = a(0, 1) * gxs + a(1, 1) * gys
        muu = torch.sum(w_g * gu * gu, dim=(1, 2))
        muv = torch.sum(w_g * gu * gv, dim=(1, 2))
        mvv = torch.sum(w_g * gv * gv, dim=(1, 2))
        norm = torch.clamp(torch.sqrt(muu * mvv - muv * muv + 1e-20),
                           min=1e-10)
        # Whiten: A <- A M^{-1/2}, renormalized to unit determinant.
        lo, hi, th = _eigh2(muu / norm, muv / norm, mvv / norm)
        f_lo = 1.0 / torch.sqrt(torch.clamp(lo, min=1e-8))
        f_hi = 1.0 / torch.sqrt(torch.clamp(hi, min=1e-8))
        c, sn = torch.cos(th), torch.sin(th)
        # M^{-1/2} = f_hi v v^T + f_lo w w^T, v = (c, s), w = (-s, c).
        i00 = f_hi * c * c + f_lo * sn * sn
        i01 = (f_hi - f_lo) * c * sn
        i11 = f_hi * sn * sn + f_lo * c * c
        inv_sqrt = _mat2(i00, i01, i01, i11)
        A2 = A @ inv_sqrt
        A = A2 / torch.sqrt(torch.clamp(_det2(A2), min=1e-10))[:, None, None]

    # Shape matrix = (A A^T)^{-1}; converged if final anisotropy small.
    AAt = A @ A.transpose(1, 2)
    B = AAt + 1e-10 * torch.eye(2, dtype=torch.float32, device=dev)
    det = _det2(B)[:, None, None]
    S = _mat2(B[:, 1, 1], -B[:, 0, 1], -B[:, 1, 0], B[:, 0, 0]) / det
    lo, hi, _ = _eigh2(AAt[:, 0, 0], AAt[:, 0, 1], AAt[:, 1, 1])
    conv = (hi / torch.clamp(lo, min=1e-10)) < 16.0
    return S, conv & mask
