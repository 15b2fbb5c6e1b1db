"""Seeded bundle adjustment problems, made on the device.

The problem of the port's BA benchmark (``scripts/bench_ba.py``'s
``make_problem``, as ``chip_smoke.make_ba_problem`` restates it), drawn
with a ``torch.Generator`` on the device in a few large calls: P points
uniform in [-10, 10]^2 x [20, 40], C cameras along the x axis (0 to 10)
with rotations of 0.01 rad, one shared pinhole row [800, 800, 512, 384],
observations with 0.5 px of noise, then poses perturbed by 2e-3 and points
by 5 cm; camera 0 is fixed. Every point is seen by two distinct cameras
(BAL's shortest track), and the remaining observations pick their point
and camera uniformly. Returns plain tensors; the generator wraps them in the
program's problem type.
"""

from __future__ import annotations

import torch

INTRINSICS = (800.0, 800.0, 512.0, 384.0)


def _so3_exp(w):
    t2 = (w * w).sum(-1, keepdim=True)
    t = torch.sqrt(t2)
    k = w / t.clamp(min=1e-12)
    z = torch.zeros_like(k[..., 0])
    K = torch.stack([z, -k[..., 2], k[..., 1], k[..., 2], z, -k[..., 0],
                     -k[..., 1], k[..., 0], z], -1).reshape(w.shape + (3,))
    s, c = torch.sin(t)[..., None], torch.cos(t)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * K + (1 - c) * (K @ K)


def make(C: int, P: int, O: int, seed: int, device):
    """A dict of poses (C, 6), points (P, 3), intrinsics (4,) float32,
    cam_idx, pt_idx (O,) int32, uv (O, 2) float32 and cam_fixed (C,)
    bool, on ``device``."""
    f64 = torch.float64
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(*shape, scale):
        return scale * torch.randn(shape, generator=g, dtype=f64,
                                   device=device)

    X = torch.rand((P, 3), generator=g, dtype=f64, device=device) * 20 - 10
    X[:, 2] += 30.0
    poses = torch.zeros((C, 6), dtype=f64, device=device)
    poses[:, 3] = torch.linspace(0, 10.0, C, dtype=f64, device=device)
    poses[:, :3] = normal(C, 3, scale=0.01)
    # Two distinct cameras for every point, then uniform draws.
    c1 = torch.randint(0, C, (P,), generator=g, device=device)
    c2 = (c1 + torch.randint(1, C, (P,), generator=g, device=device)) % C
    rest = O - 2 * P
    cam = torch.cat([c1, c2, torch.randint(0, C, (rest,), generator=g,
                                           device=device)])
    pt = torch.cat([torch.arange(P, device=device)] * 2 + [
        torch.randint(0, P, (rest,), generator=g, device=device)])
    intr = torch.tensor(INTRINSICS, dtype=f64, device=device)
    Xc = (_so3_exp(poses[cam, :3]) @ X[pt][..., None])[..., 0] + poses[cam, 3:]
    z = Xc[:, 2].clamp(min=1.0)
    uv = torch.stack([intr[0] * Xc[:, 0] / z + intr[2],
                      intr[1] * Xc[:, 1] / z + intr[3]], -1)
    uv = uv + normal(O, 2, scale=0.5)
    noise = normal(C, 6, scale=2e-3)
    noise[0] = 0.0
    cam_fixed = torch.zeros(C, dtype=torch.bool, device=device)
    cam_fixed[0] = True
    return {"poses": (poses + noise).float(),
            "points": (X + normal(P, 3, scale=5e-2)).float(),
            "intrinsics": intr.float(), "cam_idx": cam.int(),
            "pt_idx": pt.int(), "uv": uv.float(), "cam_fixed": cam_fixed}
