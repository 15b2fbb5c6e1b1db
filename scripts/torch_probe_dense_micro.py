"""Micro-probe of the lowerings of the dense BA's camera-side product
columns, on the PyTorch / CUDA port.

Twin of ``scripts/probe_dense_micro.py``. The probe asked which lowering
of pass A's camera columns (U blocks and J^T r, then their one-hot
contraction into Ucat) a TPU tiles best; on the card the same question is
which lowering ``ba/dense_schur.py::_chunk_stats`` should use. At N slots
(1,835,008 by default, the large bench's) and C cameras, in float32, each
is timed followed by its Ucat consumer (so nothing is left unused):

- ``onehot``: the one-hot (N, C) matrix alone, summed;
- ``rank3``: u36 by an (N, 6, 6) broadcast and reshape (``_chunk_stats``'
  form), J^T r, then E^T [u36 | J^T r];
- ``take``: u36 by static column-index products;
- ``pairs``: every product of the 14-vector [Jx, Jy, rx, ry] from one
  static pair table (N, 105);
- ``stack42``: the 42 columns stacked one by one;
- ``poseMM``: the pose gather as the one-hot matmul E @ poses;
- ``poseGather``: the plain pose gather.

Each is the median of 5 calls after a warm-up call (CUDA events after a
synchronize on the card, the host clock on the CPU). :func:`lowerings`
returns the functions; :func:`as_ucat` maps the ``pairs`` table onto
Ucat's 42 columns, so the lowerings can be held to one another.

It imports only ``sara_tpu_torch`` and numpy, and runs on the card unless
``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_dense_micro.py [--cams 256]
       [--n 1835008] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

REPS = 5
NAMES = ("onehot", "rank3", "take", "pairs", "stack42", "poseMM",
         "poseGather")


def make_inputs(N, C, device, dtype=None):
    """The probe's inputs from ``RandomState(0)``: Jx, Jy (N, 6), rx, ry
    (N,), cam (N,) and poses (C, 6), float32 (or ``dtype``) on
    ``device``."""
    import torch

    dtype = dtype or torch.float32
    rs = np.random.RandomState(0)

    def f(a):
        return torch.as_tensor(a.astype(np.float32)).to(device, dtype)

    Jx = f(rs.normal(size=(N, 6)))
    Jy = f(rs.normal(size=(N, 6)))
    rx = f(rs.normal(size=N))
    ry = f(rs.normal(size=N))
    cam = torch.as_tensor(rs.randint(0, C, N).astype(np.int32)).to(device)
    poses = f(rs.normal(size=(C, 6)))
    return Jx, Jy, rx, ry, cam, poses


def lowerings(C: int) -> dict:
    """name -> function of (Jx, Jy, rx, ry, cam, poses), the probe's seven
    programs; the Ucat ones return (C, 42) (``pairs`` (C, 105))."""
    import torch
    import torch.nn.functional as F

    II = np.repeat(np.arange(6), 6)
    JJ = np.tile(np.arange(6), 6)
    IIp, JJp = np.triu_indices(14)

    def onehot(cam, dt):
        return F.one_hot(cam.long(), C).to(dt)

    def ehot_only(Jx, Jy, rx, ry, cam, poses):
        return onehot(cam, Jx.dtype).sum(dim=0)

    def ucat_rank3(Jx, Jy, rx, ry, cam, poses):
        E = onehot(cam, Jx.dtype)
        N = Jx.shape[0]
        u36 = (Jx[:, :, None] * Jx[:, None, :]
               + Jy[:, :, None] * Jy[:, None, :]).reshape(N, 36)
        jtr = Jx * rx[:, None] + Jy * ry[:, None]
        return E.T @ torch.cat([u36, jtr], dim=1)

    def ucat_take(Jx, Jy, rx, ry, cam, poses):
        E = onehot(cam, Jx.dtype)
        ii = torch.as_tensor(II, device=Jx.device)
        jj = torch.as_tensor(JJ, device=Jx.device)
        u36 = (Jx.index_select(1, ii) * Jx.index_select(1, jj)
               + Jy.index_select(1, ii) * Jy.index_select(1, jj))
        jtr = Jx * rx[:, None] + Jy * ry[:, None]
        return E.T @ torch.cat([u36, jtr], dim=1)

    def ucat_pairs(Jx, Jy, rx, ry, cam, poses):
        E = onehot(cam, Jx.dtype)
        A = torch.cat([Jx, Jy, rx[:, None], ry[:, None]], dim=1)
        ii = torch.as_tensor(IIp, device=Jx.device)
        jj = torch.as_tensor(JJp, device=Jx.device)
        return E.T @ (A.index_select(1, ii) * A.index_select(1, jj))

    def ucat_stack(Jx, Jy, rx, ry, cam, poses):
        E = onehot(cam, Jx.dtype)
        cols = [Jx[:, i] * Jx[:, j] + Jy[:, i] * Jy[:, j]
                for i in range(6) for j in range(6)]
        cols += [Jx[:, i] * rx + Jy[:, i] * ry for i in range(6)]
        return E.T @ torch.stack(cols, dim=1)

    def pose_mm(Jx, Jy, rx, ry, cam, poses):
        return torch.sum(onehot(cam, poses.dtype) @ poses)

    def pose_gather(Jx, Jy, rx, ry, cam, poses):
        return torch.sum(poses[cam.long()])

    return dict(zip(NAMES, (ehot_only, ucat_rank3, ucat_take, ucat_pairs,
                            ucat_stack, pose_mm, pose_gather)))


def as_ucat(pairs):
    """The (C, 105) pair table of [Jx, Jy, rx, ry] as Ucat's (C, 42)
    columns: U[i, j] = <Jx_i Jx_j> + <Jy_i Jy_j>, J^T r_i = <Jx_i rx> +
    <Jy_i ry>."""
    IIp, JJp = np.triu_indices(14)
    col = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(IIp, JJp))}

    def at(a, b):
        return pairs[:, col[(min(a, b), max(a, b))]]

    cols = [at(i, j) + at(6 + i, 6 + j) for i in range(6) for j in range(6)]
    cols += [at(i, 12) + at(6 + i, 13) for i in range(6)]
    import torch

    return torch.stack(cols, dim=1)


def agreement(outs: dict, inputs) -> dict:
    """Each float32 lowering's largest error against the float64 product of
    the same float32 inputs, over its bound: a column entry sums n_c
    slots' terms (n_c the camera's slots), each the sum of two rounded
    products, so in any summation order it is within (2 n_c + 2) u of the
    sum of its terms' magnitudes (u = 2^-24, the float32 unit roundoff;
    Higham's worst case). The two pose sums add 6N terms: within 6N u of
    their magnitudes. A ratio <= 1 is float32 rounding."""
    import torch

    Jx, Jy, rx, ry, cam, poses = (t.double() if t.is_floating_point()
                                  else t for t in inputs)
    C = poses.shape[0]
    u = 2.0 ** -24
    fns = lowerings(C)
    exact = fns["rank3"](Jx, Jy, rx, ry, cam, poses)
    mag = fns["rank3"](Jx.abs(), Jy.abs(), rx.abs(), ry.abs(), cam, poses)
    n_c = torch.bincount(cam.long(), minlength=C).double()[:, None]
    bound = (2 * n_c + 2) * u * mag
    out = {}
    for name in ("rank3", "take", "stack42", "pairs"):
        got = outs[name].double()
        if name == "pairs":
            got = as_ucat(got)
        out[name] = float(((got - exact).abs() / bound).max())
    exact_pose = poses[cam.long()].sum()
    mag_pose = poses[cam.long()].abs().sum()
    for name in ("poseMM", "poseGather"):
        err = (outs[name].double() - exact_pose).abs()
        out[name] = float(err / (6 * cam.shape[0] * u * mag_pose))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--n", type=int, default=1_835_008,
                    help="total slots (matches the large bench)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    inputs = make_inputs(args.n, args.cams, dev)
    results, outs = {}, {}
    for name, fn in lowerings(args.cams).items():
        out, dt, first = median_ms(lambda f=fn: f(*inputs), dev, REPS)
        print(f"{name:10s} {dt:8.1f} ms   (first call {first:.1f}s)",
              flush=True)
        results[name] = dt
        outs[name] = out
    return {"ms": results, "outputs": outs, "inputs": inputs}


if __name__ == "__main__":
    main()
