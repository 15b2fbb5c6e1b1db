"""Sub-stage attribution inside the PyTorch / CUDA port's dense-Schur pass A.

Twin of ``scripts/probe_dense_passA.py``. Times cumulative prefixes of the
per-chunk work of ``ba/dense_schur.py::_chunk_stats`` over every chunk of
``bench_ba``'s problem (``scripts/torch_bench_ba.py::make_problem``,
float32, packed by ``pack_pt_major``):
  jac     - the slot residuals and Huber-weighted closed-form Jacobians
  ucat    - + the camera one-hot E and the U / J^T r contraction
  vw      - + the V blocks, bp, V^-1 and the W blocks
  d       - + the per-point camera columns D
  full    - + H, the S contraction and the right-hand side
then the S contraction alone (S_pt += H2^T D2 over the chunks, bfloat16
operands held in float32, as the port computes it) with its achieved
TFLOP/s on 2 x 3Q x (6C)^2 operations per chunk, and the same product
through ``torch.mm(..., out_dtype=torch.float32)`` on bfloat16 operands
(tensor cores) where the installed torch offers it on the device, with
its largest error relative to S. Each is the median of 3 calls after a
warm-up call: CUDA events after a synchronize on the card, the host clock
on the CPU.

It imports only ``sara_tpu_torch``, numpy, scipy and
``scripts/torch_bench_ba.py``, and runs on the card unless ``--device
cpu`` is given; without a card it raises.

Usage: python scripts/torch_probe_dense_passA.py [--cams 256]
       [--points 100000] [--obs 800000] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

REPS = 3
STAGES = ("jac", "ucat", "vw", "d", "full")


def chunk_work(ptm, lam, ch, stage, delta=4.0, cutoff=6.0):
    """``_chunk_stats`` on one chunk up to ``stage``, reduced to a sum;
    with ``stage="operands"``, the S contraction's (3Q, 6C) operands H2
    and D2 in the working dtype."""
    import torch

    from sara_tpu_torch.ba.dense_schur import (_acc, _point_blocks,
                                               _slot_residual_jac, _vinv3)

    poses, pose_free = ptm.poses, ptm.pose_free
    points_q, cam_q, uv_q, m_q, ptfix_q = ch
    Q, Sp = cam_q.shape
    C = poses.shape[0]
    dt = poses.dtype
    r, Jcf, Jpf = _slot_residual_jac(poses, points_q, ptm.intrinsics, cam_q,
                                     uv_q, m_q, ptfix_q, delta, cutoff)
    if stage == "jac":
        return r.sum() + Jcf.sum() + Jpf.sum()
    wd = r.dtype
    cams = torch.arange(C, dtype=cam_q.dtype, device=cam_q.device)
    E = ((cam_q[..., None] == cams) & m_q[..., None]).to(wd)
    N = Q * Sp
    Jx, Jy = Jcf[:, :6], Jcf[:, 6:]
    Px, Py = Jpf[:, :3], Jpf[:, 3:]
    rx, ry = r[:, 0], r[:, 1]
    u36 = (Jx[:, :, None] * Jx[:, None, :]
           + Jy[:, :, None] * Jy[:, None, :]).reshape(N, 36)
    jtr = Jx * rx[:, None] + Jy * ry[:, None]
    camcols = torch.cat([u36, jtr], dim=1)
    Ucat = _acc(E.reshape(N, C), dt).T @ _acc(camcols, dt)
    ff = (pose_free[:, :, None] * pose_free[:, None, :]).reshape(C, 36)
    Ucat = Ucat * torch.cat([ff, pose_free], dim=1)
    if stage == "ucat":
        return Ucat.sum()
    V, bp = _point_blocks(Px, Py, rx, ry, Q, Sp, dt)
    Vinv = _vinv3(V, lam, dt)
    W18 = (Px[:, :, None] * Jx[:, None, :]
           + Py[:, :, None] * Jy[:, None, :]).reshape(Q, Sp, 18)
    if stage == "vw":
        return Ucat.sum() + Vinv.sum() + W18.float().sum()
    D = torch.bmm(_acc(W18, dt).transpose(1, 2), _acc(E, dt)).to(wd)
    D = D.reshape(Q, 3, 6, C) * pose_free.T[None, None, :, :].to(wd)
    if stage == "d":
        return Ucat.sum() + D.float().sum()
    H = torch.sum(_acc(Vinv.to(wd), dt)[:, :, :, None, None]
                  * _acc(D, dt)[:, None, :, :, :], dim=2).to(wd)
    D2 = D.reshape(3 * Q, 6 * C)
    H2 = H.reshape(3 * Q, 6 * C)
    if stage == "operands":
        return H2, D2
    S_pt = _acc(H2, dt).T @ _acc(D2, dt)
    y = torch.einsum("qkl,ql->qk", Vinv, bp).reshape(3 * Q).to(wd)
    rhs_pt = (_acc(D2, dt).T @ _acc(y, dt)).reshape(6, C).T
    return Ucat.sum() + S_pt.sum() + rhs_pt.sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--obs", type=int, default=800_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch_bench_ba import make_problem

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.ba.dense_schur import _chunked, pack_pt_major
    from sara_tpu_torch.utils.timing import median_ms

    dev = resolve_device(args.device)
    print("device:", dev, flush=True)
    prob = make_problem(args.cams, args.points, args.obs, device=dev)
    ptm, stats = pack_pt_major(prob)
    Q = stats["chunk"]
    C = args.cams
    dt = ptm.poses.dtype
    lam = torch.full((), 1e-3, dtype=dt, device=dev)
    chunks = _chunked((ptm.points, ptm.cam_idx, ptm.uv, ptm.slot_mask,
                       ptm.point_fixed), Q)
    results = {}

    def timeit(name, fn):
        out, ms, first = median_ms(fn, dev, REPS)
        print(f"{name:12s} {ms:8.1f} ms   (first call {first:.1f}s)",
              flush=True)
        results[name] = ms
        return out

    for stage in STAGES:
        timeit(stage, lambda stage=stage: sum(
            chunk_work(ptm, lam, ch, stage) for ch in chunks))

    operands = [chunk_work(ptm, lam, ch, "operands") for ch in chunks]
    flops = 2.0 * sum(h.shape[0] for h, _ in operands) * (6 * C) ** 2

    def contraction():
        S = torch.zeros((6 * C, 6 * C), dtype=dt, device=dev)
        for H2, D2 in operands:
            S = S + H2.to(dt).T @ D2.to(dt)
        return S

    S = timeit("S contraction", contraction)
    ms = results["S contraction"]
    results["S_tflops"] = flops / (ms * 1e-3) / 1e12
    print(f"S contraction: {flops / 1e9:.1f} GFLOP in {ms:.2f} ms -> "
          f"{results['S_tflops']:.2f} TFLOP/s ({len(operands)} chunks of "
          f"({operands[0][0].shape[0]}, {6 * C}) operands, "
          f"{operands[0][0].dtype} held in {dt})", flush=True)

    def tensor_cores():
        S = torch.zeros((6 * C, 6 * C), dtype=torch.float32, device=dev)
        for H2, D2 in operands:
            S = S + torch.mm(H2.T, D2, out_dtype=torch.float32)
        return S

    try:
        S_tc = timeit("S bf16 mm", tensor_cores)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"S bf16 mm: not available here "
              f"({str(e).split('. ')[0][:160]})", flush=True)
    else:
        err = float((S_tc - S.float()).abs().max()
                    / S.float().abs().max().clamp_min(1e-30))
        ms = results["S bf16 mm"]
        results["S_bf16_tflops"] = flops / (ms * 1e-3) / 1e12
        results["S_bf16_rel_err"] = err
        print(f"S bf16 mm (torch.mm out_dtype=float32): "
              f"{results['S_bf16_tflops']:.2f} TFLOP/s, max error {err:.2e} "
              f"of max |S|", flush=True)
    return results


if __name__ == "__main__":
    main()
