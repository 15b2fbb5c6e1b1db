"""Work of one Levenberg-Marquardt iteration of bundle adjustment, as the
problem needs it.

Matrix-free Schur with block-Jacobi PCG (``cg_iteration_work``): per
observation the projection and its 2 x 9 Jacobian (200 operations), the
Huber weight (10), its share of U, V, W, bc and bp (2 x (36 + 9 + 18)
multiply-adds: 252), the back-substitution's W^T dc (72) and the
candidate's cost (60); per point its 3 x 3 inverse (60); each camera
block's 6 x 6 inverse (432), the reduced right-hand side (42 per
observation), and per CG step
the Schur matvec (per observation W^T x and W y, 36 each, and the two
segment sums, 3 + 6; per point its V^-1 product, 18; per camera its U_d
product and difference, 78), the preconditioner (72 per camera) and the
dots and updates (10 per camera unknown).

Bytes: the observations (two float32 pixels, two int32 indices)
and the poses, points and intrinsics read once; poses and points written
once."""

from __future__ import annotations


def cg_iteration_work(C: int, P: int, O: int, cg_iters: int):
    """(operations, bytes) of one LM iteration of ``cg_iters`` PCG steps
    over the reduced camera system."""
    ops = (594 * O + 60 * P + 432 * C + 42 * O
           + cg_iters * (81 * O + 18 * P + 210 * C))
    byts = 16 * O + 2 * (24 * C + 12 * P) + 16
    return float(ops), float(byts)
