"""Monte-Carlo validation of the port's 5-point solver against a CPU oracle.

Twin of ``scripts/mc_fivepoint.py`` on the PyTorch / CUDA port. The
solver (``sara_tpu_torch/mvg/fivepoint.py``, float64) finds the real roots
of the hidden-variable resultant by trig-series bracketing over remixed
null bases. The oracle: the SAME 10x10 cubic pencil C(z), solved exactly
by linearizing det(C0 + C1 z + C2 z^2 + C3 z^3) = 0 into a 30x30
generalized eigenproblem (scipy.linalg.eig) on the host.

For each random problem the oracle's essential matrices (validated against
the 10 essential constraints) are listed, and each must be matched by a
solver output (sign-invariant Frobenius distance). Reports the per-E
recovery rate, the rate of recovering the TRUE motion's E, and the
recovery by kind of problem (generic, near-planar, small baseline).

It imports only ``sara_tpu_torch``, numpy and scipy, and solves on the card
unless ``--device cpu`` is given; without a card it raises.

Usage: python scripts/torch_mc_fivepoint.py [--n 10000]
       [--degenerate-frac 0.3] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np


def make_problem(rs, near_planar=False, small_baseline=False):
    """Random two-view geometry; returns (u (5,2), v (5,2), E_gt)."""
    ang = rs.uniform(-0.5, 0.5, 3)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == 1:
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rot(0, ang[0]) @ rot(1, ang[1]) @ rot(2, ang[2])
    t = rs.normal(size=3)
    if small_baseline:
        t = t / np.linalg.norm(t) * 1e-3
    X = rs.uniform(-1, 1, (5, 3)) + np.array([0, 0, 4.0])
    if near_planar:
        n_vec = rs.normal(size=3)
        n_vec /= np.linalg.norm(n_vec)
        X = X - 0.999 * np.outer((X - X.mean(0)) @ n_vec, n_vec)
    u = X[:, :2] / X[:, 2:]
    Xb = X @ R.T + t
    v = Xb[:, :2] / Xb[:, 2:]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return u, v, E / np.linalg.norm(E)


def essential_residual(E):
    EEt = E @ E.T
    M = 2 * EEt @ E - np.trace(EEt) * E
    return np.sqrt(np.linalg.det(E) ** 2 + (M ** 2).sum())


def oracle_solutions(u, v):
    """All real essential matrices via the generalized companion of the
    same pencil the solver uses (its coefficient matrices by the port's
    ``_coefficient_matrices``, in float64 on the CPU)."""
    import scipy.linalg
    import torch

    from sara_tpu_torch.mvg.fivepoint import _coefficient_matrices

    A = np.stack([
        np.array([vx * ux, vx * uy, vx, vy * ux, vy * uy, vy, ux, uy, 1.0])
        for (ux, uy), (vx, vy) in zip(u, v)])
    _, _, Vt = np.linalg.svd(A)
    basis = Vt[-4:].reshape(4, 3, 3)
    C = _coefficient_matrices(*(torch.from_numpy(b) for b in basis)).numpy()
    C0, C1, C2, C3 = C
    # Linearization: det(C0 + C1 z + C2 z^2 + C3 z^3) = 0 as Az = z Bz.
    I = np.eye(10)
    Z = np.zeros((10, 10))
    Abig = np.block([[Z, I, Z], [Z, Z, I], [-C0, -C1, -C2]])
    Bbig = np.block([[I, Z, Z], [Z, I, Z], [Z, Z, C3]])
    w = scipy.linalg.eig(Abig, Bbig, right=False)
    zs = [z.real for z in w
          if np.isfinite(z) and abs(z.imag) < 1e-8 * max(1.0, abs(z.real))]
    out = []
    for z in zs:
        Cz = C0 + C1 * z + C2 * z * z + C3 * z ** 3
        _, s, Vt2 = np.linalg.svd(Cz)
        m = Vt2[-1]
        if abs(m[9]) < 1e-9:
            continue
        x, y = m[7] / m[9], m[8] / m[9]
        E = x * basis[0] + y * basis[1] + z * basis[2] + basis[3]
        E = E / np.linalg.norm(E)
        if essential_residual(E) < 1e-6:
            # Epipolar consistency on the 5 points.
            ep = max(abs(np.array([vx, vy, 1.0]) @ E @ np.array([ux, uy, 1.0]))
                     for (ux, uy), (vx, vy) in zip(u, v))
            if ep < 1e-6:
                out.append(E)
    # Dedup (sign-invariant).
    dedup = []
    for E in out:
        if all(min(np.linalg.norm(E - F), np.linalg.norm(E + F)) > 1e-4
               for F in dedup):
            dedup.append(E)
    return dedup


def run(n, degenerate_frac=0.3, seed=0, tol=1e-3, batch=256,
        device="cuda"):
    import torch

    from sara_tpu_torch import resolve_device
    from sara_tpu_torch.mvg.fivepoint import five_point_essential

    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    probs, kinds = [], []
    for i in range(n):
        kind = rs.rand()
        near_planar = kind < degenerate_frac
        small = degenerate_frac <= kind < 1.5 * degenerate_frac
        probs.append(make_problem(rs, near_planar=near_planar,
                                  small_baseline=small))
        kinds.append("near_planar" if near_planar
                     else "small_baseline" if small else "generic")

    n_oracle = n_found = 0
    n_true = n_true_found = 0
    by_kind = {k: [0, 0] for k in ("generic", "near_planar",
                                   "small_baseline")}
    worst = []
    for c0 in range(0, n, batch):
        chunk = probs[c0:c0 + batch]
        U = torch.as_tensor(np.stack([p[0] for p in chunk]), device=dev)
        V = torch.as_tensor(np.stack([p[1] for p in chunk]), device=dev)
        Es, valids = five_point_essential(U, V)
        Es = Es.cpu().numpy()
        valids = valids.cpu().numpy()
        for k, (u, v, E_gt) in enumerate(chunk):
            ours = [Es[k][i] / max(np.linalg.norm(Es[k][i]), 1e-12)
                    for i in range(Es.shape[1]) if valids[k][i]]
            oracle = oracle_solutions(u, v)
            n_oracle += len(oracle)
            tally = by_kind[kinds[c0 + k]]
            for E in oracle:
                hit = any(min(np.linalg.norm(E - F), np.linalg.norm(E + F))
                          < tol for F in ours)
                n_found += hit
                tally[0] += 1
                tally[1] += hit
                if not hit:
                    worst.append((c0 + k, essential_residual(E)))
            n_true += 1
            n_true_found += any(
                min(np.linalg.norm(E_gt - F), np.linalg.norm(E_gt + F)) < 1e-2
                for F in ours)
    return {
        "problems": n,
        "oracle_solutions": n_oracle,
        "recovered": n_found,
        "recovery_rate": n_found / max(n_oracle, 1),
        "true_E_rate": n_true_found / max(n_true, 1),
        "misses": worst[:20],
        "recovery_by_kind": {k: v[1] / max(v[0], 1)
                             for k, v in by_kind.items()},
        "oracle_by_kind": {k: v[0] for k, v in by_kind.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--degenerate-frac", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.n, args.degenerate_frac, args.seed, device=args.device)
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
