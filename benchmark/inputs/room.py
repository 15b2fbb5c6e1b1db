"""Seeded renders of a textured room along a driving path, on the device.

A frozen copy of the repository's test renderer (``tests/render3d.py``:
textured planes, ray-plane intersection, bilinear texture reads), rewritten
in PyTorch so that a run renders its frames on the card in a few calls.
The room is a street-like box: a floor 1.2 m below the camera, a back wall
12 m ahead and a wall on either side. Textures are smooth random noise at
three scales, drawn from the seed on the device.

The camera is KITTI odometry's left grey camera (sequence 00: fx = fy =
718.856, cx = 607.1928, cy = 185.2157, 376 x 1241 pixels); the right camera
sits 0.537 m to its right, KITTI's stereo baseline. The path is a closed
loop in the floor plane, so a cycled sequence has no jump.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
KITTI_HW = (376, 1241)
BASELINE_M = 0.537
TEX_SIZE = 512

# (origin, u axis, v axis, u range, v range) of each plane.
_PLANES = (
    ((0.0, 1.2, 6.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (-4, 4), (-6, 6)),
    ((0.0, 0.0, 12.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (-4, 4), (-3, 3)),
    ((-4.0, 0.0, 6.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-6, 6), (-3, 3)),
    ((4.0, 0.0, 6.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (-6, 6), (-3, 3)),
)


def _blur(t: torch.Tensor, sigma: float) -> torch.Tensor:
    r = int(math.ceil(3 * sigma))
    x = torch.arange(-r, r + 1, dtype=t.dtype, device=t.device)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = k / k.sum()
    y = F.pad(t[None, None], (r, r, r, r), mode="circular")
    y = F.conv2d(y, k.view(1, 1, 1, -1))
    return F.conv2d(y, k.view(1, 1, -1, 1))[0, 0]


def textures(gen: torch.Generator, n: int, size: int, device):
    """``n`` smooth noise textures (size x size) in [0.15, 0.85]."""
    out = []
    for _ in range(n):
        t = torch.rand((size, size), generator=gen, device=device)
        t = 0.5 * _blur(t, 2.0) + 0.3 * _blur(t, 6.0) + 0.2 * _blur(t, 16.0)
        t = (t - t.min()) / (t.max() - t.min()).clamp(min=1e-9)
        out.append(0.15 + 0.7 * t)
    return torch.stack(out)


def loop_poses(n: int, phase: float, device):
    """``n`` world-to-camera poses (R (n, 3, 3), t (n, 3)) around a closed
    loop of radii 1.5 m (x) and 2 m (z), facing the back wall with a yaw
    that follows the loop by up to 6 degrees."""
    a = phase + torch.arange(n, dtype=torch.float64, device=device) * (
        2 * math.pi / n)
    cx = 1.5 * torch.cos(a)
    cz = 4.0 + 2.0 * torch.sin(a)
    yaw = math.radians(6.0) * torch.sin(a)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    # Camera-to-world rotation about y; world-to-camera is its transpose.
    Rcw = torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1).view(n, 3, 3)
    R = Rcw.transpose(1, 2)
    centre = torch.stack([cx, torch.zeros_like(cx), cz], dim=-1)
    t = -(R @ centre[..., None])[..., 0]
    return R, t


def render(tex: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
           K=KITTI_K, hw=KITTI_HW) -> torch.Tensor:
    """(n, H, W) float32 renders of the room from poses R (n, 3, 3),
    t (n, 3); ``tex`` holds one texture per plane."""
    H, W = hw
    dev = R.device
    fx, fy, cx, cy = K
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev),
                            indexing="ij")
    rays = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                        torch.ones_like(xs)], dim=-1).view(-1, 3)
    Rw = R.transpose(1, 2)                              # camera -> world
    rays_w = torch.einsum("nij,pj->npi", Rw, rays)      # (n, HW, 3)
    centre = -(Rw @ t[..., None])[..., 0]               # (n, 3)
    best = torch.full(rays_w.shape[:2], math.inf, dtype=torch.float64,
                      device=dev)
    img = torch.full(rays_w.shape[:2], 0.05, dtype=torch.float32, device=dev)
    th, tw = tex.shape[-2:]
    for i, (o, u, v, ur, vr) in enumerate(_PLANES):
        o, u, v = (torch.tensor(a, dtype=torch.float64, device=dev)
                   for a in (o, u, v))
        nrm = torch.linalg.cross(u, v)
        nrm = nrm / nrm.norm()
        denom = rays_w @ nrm
        num = (o - centre) @ nrm                        # (n,)
        tt = num[:, None] / torch.where(denom.abs() < 1e-12,
                                        torch.full_like(denom, 1e-12), denom)
        pts = centre[:, None, :] + rays_w * tt[..., None]
        du = (pts - o) @ u
        dv = (pts - o) @ v
        inside = ((tt > 0.1) & (du >= ur[0]) & (du <= ur[1])
                  & (dv >= vr[0]) & (dv <= vr[1]))
        closer = inside & (tt < best)
        ui = ((du - ur[0]) / (ur[1] - ur[0]) * (tw - 1)).clamp(0, tw - 1)
        vi = ((dv - vr[0]) / (vr[1] - vr[0]) * (th - 1)).clamp(0, th - 1)
        u0 = ui.floor().long()
        v0 = vi.floor().long()
        u1 = (u0 + 1).clamp(max=tw - 1)
        v1 = (v0 + 1).clamp(max=th - 1)
        fu = (ui - u0).float()
        fv = (vi - v0).float()
        T = tex[i]
        val = (T[v0, u0] * (1 - fu) * (1 - fv) + T[v0, u1] * fu * (1 - fv)
               + T[v1, u0] * (1 - fu) * fv + T[v1, u1] * fu * fv)
        img = torch.where(closer, val, img)
        best = torch.where(closer, tt, best)
    return img.view(-1, H, W)


def sequence(seed: int, n: int, device, stereo: bool = False,
             hw=KITTI_HW):
    """The seed's room and ``n`` frames around its loop, (n, H, W) float32
    on ``device``; with ``stereo`` (n, 2, H, W), left then right. The seed
    draws the textures and where the loop starts."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tex = textures(gen, len(_PLANES), TEX_SIZE, device)
    phase = float(torch.rand((), generator=gen, device=device)) * 2 * math.pi
    R, t = loop_poses(n, phase, device)
    # A smaller frame keeps KITTI's field of view.
    K = tuple(k * hw[1] / KITTI_HW[1] for k in KITTI_K)

    def frames(tt):
        return torch.cat([render(tex, R[i:i + 8], tt[i:i + 8], K, hw)
                          for i in range(0, n, 8)])

    left = frames(t)
    if not stereo:
        return left
    shift = torch.tensor([BASELINE_M, 0.0, 0.0], dtype=t.dtype, device=device)
    return torch.stack([left, frames(t - shift)], dim=1)
