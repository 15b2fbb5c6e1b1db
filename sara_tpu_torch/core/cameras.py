"""Camera models: pinhole, Brown-Conrady, Kannala-Brandt fisheye, omnidirectional.

Twin of ``sara_tpu/core/cameras.py`` (reference:
cpp/src/DO/Sara/MultiViewGeometry/Camera/v2/PinholeCamera.hpp:125-140,
v2/BrownConradyCamera.hpp:153-205, v2/OmnidirectionalCamera.hpp:226-300,
Camera/KannalaBrandtFisheyeDistortionModel.hpp).

Every model is a NamedTuple of tensors. ``project`` maps a camera-frame 3-D
point to pixels, ``backproject`` maps pixels to a ray in the camera frame.
The reference's ``lax.fori_loop`` fixed-point and Newton iterations are
plain loops with the same iteration counts. The constructors build float32
tensors on ``device`` (None = the CUDA device; raises without one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sara_tpu_torch import resolve_device


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(resolve_device(device))


class Pinhole(NamedTuple):
    """fx, fy, shear s, principal point (u0, v0)."""

    fx: torch.Tensor
    fy: torch.Tensor
    s: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor

    @staticmethod
    def from_values(fx, fy, u0, v0, s=0.0, device=None) -> "Pinhole":
        return Pinhole(*(_f32(v, device) for v in (fx, fy, s, u0, v0)))

    @staticmethod
    def from_matrix(K, device=None) -> "Pinhole":
        K = _f32(K, device)
        return Pinhole(K[..., 0, 0], K[..., 1, 1], K[..., 0, 1],
                       K[..., 0, 2], K[..., 1, 2])

    def matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        K = torch.stack([self.fx, self.s, self.u0,
                         z, self.fy, self.v0,
                         z, z, o], dim=-1)
        return K.reshape(self.fx.shape + (3, 3))

    def project(self, X: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3-D point(s) (..., 3) -> pixel(s) (..., 2)."""
        x = X[..., 0] / X[..., 2]
        y = X[..., 1] / X[..., 2]
        u = self.fx * x + self.s * y + self.u0
        v = self.fy * y + self.v0
        return torch.stack([u, v], dim=-1)

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel(s) (..., 2) -> ray(s) (..., 3) with z=1."""
        y = (uv[..., 1] - self.v0) / self.fy
        x = (uv[..., 0] - self.u0 - self.s * y) / self.fx
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)


class BrownConrady(NamedTuple):
    """Pinhole + radial (k1,k2,k3) and tangential (p1,p2) distortion.

    ``x_d = x (1 + k1 r^2 + k2 r^4 + k3 r^6) + (r^2 I + 2 x x^T) p``
    (reference: v2/BrownConradyCamera.hpp:153-170).
    """

    K: Pinhole
    k: torch.Tensor  # (3,) radial
    p: torch.Tensor  # (2,) tangential

    @staticmethod
    def from_values(fx, fy, u0, v0, k=(0.0, 0.0, 0.0), p=(0.0, 0.0), s=0.0,
                    device=None):
        return BrownConrady(Pinhole.from_values(fx, fy, u0, v0, s, device),
                            _f32(k, device), _f32(p, device))

    def distort(self, xn: torch.Tensor) -> torch.Tensor:
        """Normalized coords (..., 2) -> distorted normalized coords."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = (1.0 + self.k[0] * r2 + self.k[1] * r2 * r2
                  + self.k[2] * r2 * r2 * r2)
        p1, p2 = self.p[0], self.p[1]
        tx = r2 * p1 + 2.0 * x * (x * p1 + y * p2)
        ty = r2 * p2 + 2.0 * y * (x * p1 + y * p2)
        return torch.stack([x * radial + tx, y * radial + ty], dim=-1)

    def undistort(self, xd: torch.Tensor, iters: int = 10) -> torch.Tensor:
        """Inverse distortion by fixed-point iteration x <- xd - d(x) + x
        (reference: v2/BrownConradyCamera.hpp:173-184)."""
        xu = xd
        for _ in range(iters):
            xu = xd - (self.distort(xu) - xu)
        return xu

    def project(self, X: torch.Tensor) -> torch.Tensor:
        xn = X[..., :2] / X[..., 2:3]
        xd = self.distort(xn)
        z = torch.ones_like(xd[..., :1])
        return self.K.project(torch.cat([xd, z], dim=-1))

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        ray = self.K.backproject(uv)
        xu = self.undistort(ray[..., :2])
        return torch.cat([xu, torch.ones_like(xu[..., :1])], dim=-1)


def _kb_poly(k, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2]
                                                          + t2 * k[3]))))


class KannalaBrandt(NamedTuple):
    """Fisheye model: theta-polynomial distortion (k1..k4),
    r(theta) = theta + k1 theta^3 + k2 theta^5 + k3 theta^7 + k4 theta^9."""

    K: Pinhole
    k: torch.Tensor  # (4,)

    def project(self, X: torch.Tensor) -> torch.Tensor:
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.arctan2(r, z)
        rd = _kb_poly(self.k, theta)
        scale = torch.where(r > 1e-8, rd / torch.clamp(r, min=1e-8),
                            torch.ones_like(r))
        xd = torch.stack([x * scale, y * scale], dim=-1)
        one = torch.ones_like(xd[..., :1])
        return self.K.project(torch.cat([xd, one], dim=-1))

    def backproject(self, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
        xd = self.K.backproject(uv)[..., :2]
        rd = torch.linalg.vector_norm(xd, dim=-1)
        k = self.k
        theta = rd
        for _ in range(iters):
            t2 = theta * theta
            f = _kb_poly(k, theta) - rd
            df = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (
                7 * k[2] + t2 * 9 * k[3])))
            theta = theta - f / torch.clamp(df, min=1e-8)
        scale = torch.where(rd > 1e-8,
                            torch.sin(theta) / torch.clamp(rd, min=1e-8),
                            torch.ones_like(rd))
        z = torch.cos(theta)
        return torch.stack([xd[..., 0] * scale, xd[..., 1] * scale, z],
                           dim=-1)


class Omnidirectional(NamedTuple):
    """Unified mirror model (xi) + Brown-Conrady distortion: lift to the
    unit sphere, shift by xi along z, divide, distort, apply K (reference:
    v2/OmnidirectionalCamera.hpp:226-300)."""

    K: Pinhole
    k: torch.Tensor   # (3,) radial
    p: torch.Tensor   # (2,) tangential
    xi: torch.Tensor  # mirror parameter

    def _bc(self) -> BrownConrady:
        return BrownConrady(self.K, self.k, self.p)

    def project(self, X: torch.Tensor) -> torch.Tensor:
        Xs = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
        denom = Xs[..., 2] + self.xi
        xn = Xs[..., :2] / denom[..., None]
        xd = self._bc().distort(xn)
        one = torch.ones_like(xd[..., :1])
        return self.K.project(torch.cat([xd, one], dim=-1))

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        xd = self.K.backproject(uv)[..., :2]
        xu = self._bc().undistort(xd)
        r2 = torch.sum(xu * xu, dim=-1)
        xi = self.xi
        disc = torch.sqrt(1.0 + (1.0 - xi * xi) * r2)
        eta = (xi + disc) / (1.0 + r2)
        z = eta - xi
        return torch.cat([eta[..., None] * xu, z[..., None]], dim=-1)


def undistortion_maps(camera, height: int, width: int):
    """Dense per-pixel sampling maps for warping a distorted image to pinhole.

    Returns (map_u, map_v), each (H, W) float32 on the camera's device: for
    each undistorted output pixel, the source pixel in the distorted input
    (reference: SfM/Odometry/ImageDistortionCorrector.hpp:21-60).
    """
    K = camera.K if hasattr(camera, "K") else camera
    dev = K.fx.device
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)  # (H, W, 2)
    xn = K.backproject(uv)[..., :2]
    if isinstance(camera, BrownConrady):
        xd = camera.distort(xn)
    elif isinstance(camera, Pinhole):
        xd = xn
    else:
        # Generic: project the (xn, 1) ray through the full model.
        ray = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
        pix = camera.project(ray)
        return pix[..., 0], pix[..., 1]
    one = torch.ones_like(xd[..., :1])
    pix = K.project(torch.cat([xd, one], dim=-1))
    return pix[..., 0], pix[..., 1]
