"""Port parity: Slice B's geometry modules against their ``sara_tpu`` twins.

Inputs are seeded numpy arrays cast to float32 on both sides (the suite's
conftest turns on JAX x64, so the casts keep the JAX side in float32 too).
Tolerances are stated per test. SVD null vectors and eigenvectors carry an
arbitrary sign on each side, so models are compared after Frobenius
normalization and a sign fix, and solution sets by nearest match.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core import lie as jlie
from sara_tpu.core import poly as jpoly
from sara_tpu.mvg import degeneracy as jdeg
from sara_tpu.mvg import extra_solvers as jextra
from sara_tpu.mvg import fivepoint as jfive
from sara_tpu.mvg import normalizer as jnorm
from sara_tpu.mvg import p3p as jp3p
from sara_tpu.mvg import solvers as jsolv
from sara_tpu.mvg import two_view as jtv
from sara_tpu.ops import smallmat as jsm
from sara_tpu_torch.core import lie as tlie
from sara_tpu_torch.core import poly as tpoly
from sara_tpu_torch.mvg import degeneracy as tdeg
from sara_tpu_torch.mvg import extra_solvers as textra
from sara_tpu_torch.mvg import fivepoint as tfive
from sara_tpu_torch.mvg import normalizer as tnorm
from sara_tpu_torch.mvg import p3p as tp3p
from sara_tpu_torch.mvg import solvers as tsolv
from sara_tpu_torch.mvg import two_view as ttv
from sara_tpu_torch.ops import smallmat as tsm

sys.path.insert(0, str(Path(__file__).resolve().parent))
from geometry_fixtures import (default_K, make_relative_motion,  # noqa: E402
                               project, rotation_distance,
                               translation_angle, two_view_scene)


def f32(a):
    return np.asarray(a, np.float32)


def J(a):
    return jnp.asarray(f32(a))


def T(a):
    return torch.from_numpy(f32(a).copy())


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), atol=atol,
                               rtol=rtol)


def sign_fixed(M):
    """Frobenius-normalized with the largest-magnitude entry positive."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def nearest(E, Fs):
    """Sign-invariant Frobenius distance of E to the nearest of Fs."""
    E = E / np.linalg.norm(E)
    return min(min(np.linalg.norm(E - F / np.linalg.norm(F)),
                   np.linalg.norm(E + F / np.linalg.norm(F))) for F in Fs)


def well_conditioned(rs, n, batch=(6,)):
    return rs.rand(*batch, n, n) + n * np.eye(n)


# ---------------------------------------------------------------------------
# ops/smallmat.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 10])
def test_smallmat_det_inv_solve(n):
    """det / inv / solve of well-conditioned batches, rtol 1e-5 (float32;
    the port's LU and the reference's Gauss-Jordan round differently)."""
    rs = np.random.RandomState(n)
    A = well_conditioned(rs, n)
    B = rs.rand(6, n, 3)
    close(tsm.batched_det(T(A)), jsm.batched_det(J(A)), 0, 1e-5)
    close(tsm.batched_inv(T(A)), jsm.batched_inv(J(A)), 1e-6, 1e-5)
    close(tsm.batched_solve(T(A), T(B)), jsm.batched_solve(J(A), J(B)),
          1e-6, 1e-5)
    if n == 3:
        close(tsm.det3(T(A)), jsm.det3(J(A)), 0, 1e-6)
        close(tsm.inv3(T(A)), jsm.inv3(J(A)), 0, 1e-6)
    if n == 2:
        close(tsm.inv2(T(A)), jsm.inv2(J(A)), 0, 1e-6)


# ---------------------------------------------------------------------------
# core/poly.py
# ---------------------------------------------------------------------------

def test_poly_eval_derivative_companion():
    rs = np.random.RandomState(1)
    c = rs.randn(5, 6)
    x = rs.randn(5, 7)
    close(tpoly.polyval(T(c)[:, None, :], T(x)),
          jpoly.polyval(J(c)[:, None, :], J(x)), 1e-5, 1e-5)
    close(tpoly.polyder(T(c)), jpoly.polyder(J(c)), 0, 1e-7)
    close(tpoly.companion_matrix(T(c)), jpoly.companion_matrix(J(c)), 0,
          1e-6)


def test_poly_real_roots_bracketed():
    """Degree-6 polynomials with 4 known real roots: same slots and
    validity as the reference, roots to 1e-4."""
    rs = np.random.RandomState(2)
    coeffs = []
    for _ in range(8):
        roots = np.array([-2.5, -0.8, 0.9, 2.4]) + rs.uniform(-0.2, 0.2, 4)
        quad = [1.0, rs.uniform(-1, 1), rs.uniform(2, 4)]  # complex pair
        coeffs.append(np.polymul(np.poly(roots), quad))
    coeffs = np.stack(coeffs)
    rt, vt = tpoly.real_roots_bracketed(T(coeffs), max_roots=6)
    rj, vj = jpoly.real_roots_bracketed(J(coeffs), max_roots=6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(rt.numpy()[vt.numpy()], np.asarray(rj)[np.asarray(vj)], 1e-4)
    assert vt.numpy().sum(-1).tolist() == [4] * 8


def test_poly_first_true_keeps_index_order():
    """The top_k replacement: ties of a 0/1 score, lowest index first."""
    mask = np.random.RandomState(3).rand(7, 40) < 0.3
    _, ref = jax.lax.top_k(jnp.where(jnp.asarray(mask), 1.0, 0.0), 5)
    np.testing.assert_array_equal(
        tpoly.first_true(torch.from_numpy(mask), 5).numpy(), np.asarray(ref))


def test_poly_closed_forms():
    """Quadratic and cubic closed forms, 1e-4 relative (float32)."""
    rs = np.random.RandomState(4)
    a, b, c, d = (rs.randn(50) for _ in range(4))
    rt, vt = tpoly.roots_quadratic(T(a), T(b), T(c))
    rj, vj = jpoly.roots_quadratic(J(a), J(b), J(c))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(rt.numpy()[vt.numpy()], np.asarray(rj)[np.asarray(vj)], 1e-5,
          1e-4)
    close(tpoly.roots_cubic_single_real(T(a), T(b), T(c), T(d)),
          jpoly.roots_cubic_single_real(J(a), J(b), J(c), J(d)), 1e-4, 1e-4)
    rt, vt = tpoly.roots_cubic(T(a), T(b), T(c), T(d))
    rj, vj = jpoly.roots_cubic(J(a), J(b), J(c), J(d))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    close(rt.numpy()[vt.numpy()], np.asarray(rj)[np.asarray(vj)], 1e-4,
          1e-4)


# ---------------------------------------------------------------------------
# core/lie.py
# ---------------------------------------------------------------------------

@pytest.fixture
def lie_inputs():
    rs = np.random.RandomState(5)
    w = rs.uniform(-1.5, 1.5, (8, 3))
    w[0] = 1e-6                                      # small-angle branch
    return dict(w=w, v=rs.randn(8, 3), q=rs.randn(8, 4), p=rs.randn(8, 3),
                s=rs.uniform(0.5, 2.0, 8), ang=rs.uniform(-3, 3, (3, 8)))


def test_lie_quaternions(lie_inputs):
    q, p = lie_inputs["q"], lie_inputs["p"]
    qn = tlie.quat_normalize(T(q))
    close(qn, jlie.quat_normalize(J(q)), 1e-6)
    qj = jlie.quat_normalize(J(q))
    close(tlie.quat_multiply(qn, qn.flip(0)),
          jlie.quat_multiply(qj, qj[::-1]), 1e-6)
    close(tlie.quat_conjugate(qn), jlie.quat_conjugate(qj), 1e-6)
    close(tlie.quat_rotate(qn, T(p)), jlie.quat_rotate(qj, J(p)), 1e-5)
    R = tlie.quat_to_matrix(qn)
    close(R, jlie.quat_to_matrix(qj), 1e-6)
    close(tlie.matrix_to_quat(R), jlie.matrix_to_quat(J(R.numpy())), 1e-6)
    close(tlie.quat_identity(), jlie.quat_identity(), 0)


def test_lie_so3_se3(lie_inputs):
    w, v = lie_inputs["w"], lie_inputs["v"]
    R = tlie.so3_exp(T(w))
    close(R, jlie.so3_exp(J(w)), 1e-6)
    close(tlie.skew(T(w)), jlie.skew(J(w)), 0)
    close(tlie.so3_log(R), jlie.so3_log(J(R.numpy())), 1e-5)
    xi = np.concatenate([w, v], axis=1)
    Rt, tt = tlie.se3_exp(T(xi))
    Rj, tj = jlie.se3_exp(J(xi))
    close(Rt, Rj, 1e-6)
    close(tt, tj, 1e-5)
    close(tlie.se3_log(Rt, tt), jlie.se3_log(Rj, tj), 1e-4)
    for name in ("se3_compose", "se3_inverse", "se3_apply"):
        args_t = {"se3_compose": (Rt, tt, Rt.flip(0), tt.flip(0)),
                  "se3_inverse": (Rt, tt), "se3_apply": (Rt, tt, T(v))}[name]
        args_j = tuple(J(a.numpy()) for a in args_t)
        for a, b in zip(getattr(tlie, name)(*args_t),
                        getattr(jlie, name)(*args_j)):
            close(a, b, 1e-5)
    close(tlie.se3_apply(Rt, tt, T(v)), jlie.se3_apply(Rj, tj, J(v)), 1e-5)


def test_lie_sim3(lie_inputs):
    """Sim(3); _sim3_W to 1e-6 (the reference's 18-term series is good to
    about 1e-6, ADVICE.md)."""
    w, v, s = lie_inputs["w"], lie_inputs["v"], lie_inputs["s"]
    sigma = np.log(s)
    close(tlie._sim3_W(T(w), T(sigma)), jlie._sim3_W(J(w), J(sigma)), 1e-6)
    R = tlie.so3_exp(T(w))
    Rj = J(R.numpy())
    close(tlie.sim3_log(R, T(v), T(s)), jlie.sim3_log(Rj, J(v), J(s)), 1e-4)
    for a, b in zip(tlie.sim3_compose(R, T(v), T(s), R.flip(0), T(v[::-1]),
                                      T(s[::-1])),
                    jlie.sim3_compose(Rj, J(v), J(s), Rj[::-1], J(v[::-1]),
                                      J(s[::-1]))):
        close(a, b, 1e-5)
    for a, b in zip(tlie.sim3_inverse(R, T(v), T(s)),
                    jlie.sim3_inverse(Rj, J(v), J(s))):
        close(a, b, 1e-5)


def test_lie_ypr_and_projection(lie_inputs):
    psi, theta, phi = lie_inputs["ang"]
    theta = theta / 3.0                              # keep pitch in range
    R = tlie.rotation_ypr(T(psi), T(theta), T(phi))
    close(R, jlie.rotation_ypr(J(psi), J(theta), J(phi)), 1e-6)
    for name in ("rotation_x", "rotation_y", "rotation_z"):
        close(getattr(tlie, name)(T(psi)), getattr(jlie, name)(J(psi)), 1e-6)
    for a, b in zip(tlie.matrix_to_ypr(R), jlie.matrix_to_ypr(J(R.numpy()))):
        close(a, b, 1e-5)
    rs = np.random.RandomState(6)
    K = np.array([[800.0, 2.0, 320.0], [0.0, 790.0, 240.0], [0.0, 0.0, 1.0]])
    P = np.stack([(K @ np.concatenate([Ri, rs.randn(3, 1)], axis=1))
                  * rs.choice([-2.0, 3.0]) for Ri in R.numpy()])
    out_t = tlie.decompose_projection_matrix(T(P))
    for i in range(len(P)):          # the reference takes one P at a time
        for a, b, tol in zip(out_t, jlie.decompose_projection_matrix(J(P[i])),
                             (1e-2, 1e-5, 1e-4)):
            close(a[i], b, tol, 1e-5)
    A = rs.randn(4, 3, 3)
    for a, b in zip(tlie.rq_factorization(T(A)), jlie.rq_factorization(J(A))):
        close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# mvg/normalizer.py
# ---------------------------------------------------------------------------

def test_normalizer():
    rs = np.random.RandomState(7)
    x = rs.uniform(0, 640, (30, 2))
    y = rs.uniform(0, 640, (30, 2))
    mask = rs.rand(30) > 0.3
    xt, Tt = tnorm.normalize_points(T(x), torch.from_numpy(mask))
    xj, Tj = jnorm.normalize_points(J(x), jnp.asarray(mask))
    close(xt, xj, 1e-5)
    close(Tt, Tj, 1e-5, 1e-6)
    out_t = tnorm.hartley_normalize(T(x), T(y))
    out_j = jnorm.hartley_normalize(J(x), J(y))
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-5, 1e-6)
    M = rs.randn(3, 3)
    close(tnorm.denormalize_fundamental(T(M), out_t[2], out_t[3]),
          jnorm.denormalize_fundamental(J(M), out_j[2], out_j[3]), 1e-6, 1e-5)
    close(tnorm.denormalize_homography(T(M), out_t[2], out_t[3]),
          jnorm.denormalize_homography(J(M), out_j[2], out_j[3]), 1e-4, 1e-4)
    # Batched samples normalize as the reference does one by one.
    xb, Tb = tnorm.normalize_points(T(x.reshape(5, 6, 2)))
    for i in range(5):
        xi, Ti = jnorm.normalize_points(J(x.reshape(5, 6, 2)[i]))
        close(xb[i], xi, 1e-5)
        close(Tb[i], Ti, 1e-5, 1e-6)


# ---------------------------------------------------------------------------
# mvg/solvers.py
# ---------------------------------------------------------------------------

def test_solvers_eight_and_four_point():
    """Null-space models to 1e-4 after normalization and a sign fix."""
    sc = two_view_scene()
    un, vn = sc["un"][8:16], sc["vn"][8:16]
    Ft, vt = tsolv.eight_point_fundamental(T(un), T(vn))
    Fj, vj = jsolv.eight_point_fundamental(J(un), J(vn))
    assert Ft.shape == (1, 3, 3) and bool(vt[0]) and bool(vj[0])
    close(sign_fixed(Ft[0]), sign_fixed(Fj[0]), 1e-4)
    rs = np.random.RandomState(3)
    Xp = np.concatenate([rs.uniform(-1, 1, (12, 2)), np.full((12, 1), 5.0)],
                        axis=1)
    R, t = make_relative_motion()
    u, _ = project(default_K(), np.eye(3), np.zeros(3), Xp)
    v, _ = project(default_K(), R, t, Xp)
    un_, _ = jnorm.normalize_points(J(u[:4]))
    vn_, _ = jnorm.normalize_points(J(v[:4]))
    Ht, _ = tsolv.four_point_homography(T(un_), T(vn_))
    Hj, _ = jsolv.four_point_homography(un_, vn_)
    close(Ht[0], Hj[0], 1e-4, 1e-4)
    # A batch of samples solves as the reference does one by one.
    Hb, vb = tsolv.four_point_homography(T(np.stack([un_, un_])),
                                         T(np.stack([vn_, vn_])))
    assert Hb.shape == (2, 1, 3, 3) and vb.shape == (2, 1)
    close(Hb[1, 0], Hj[0], 1e-4, 1e-4)


def test_solvers_seven_point():
    """Each valid reference solution has a port solution within 1e-3."""
    for seed in range(4):
        sc = two_view_scene(seed=seed)
        un, vn, _, _ = jnorm.hartley_normalize(J(sc["un"][8:15]),
                                               J(sc["vn"][8:15]))
        Ft, vt = tsolv.seven_point_fundamental(T(un), T(vn))
        Fj, vj = jsolv.seven_point_fundamental(un, vn)
        ours = [Ft[i].numpy() for i in range(3) if vt[i]]
        for i in range(3):
            if vj[i]:
                assert nearest(np.asarray(Fj[i]), ours) < 1e-3


# ---------------------------------------------------------------------------
# mvg/two_view.py
# ---------------------------------------------------------------------------

def test_two_view_motions_and_distances():
    sc = two_view_scene(noise=0.5, seed=3)
    E = sc["E"]
    R4t, t4t = ttv.essential_to_motions(T(E))
    R4j, t4j = jtv.essential_to_motions(J(E))
    # The four candidates as a set (SVD signs may order them otherwise).
    for i in range(4):
        d = min(np.abs(R4t[k].numpy() - np.asarray(R4j[i])).max()
                + np.abs(t4t[k].numpy() - np.asarray(t4j[i])).max()
                for k in range(4))
        assert d < 1e-5
    un, vn = sc["un"], sc["vn"]
    for name in ("sampson_epipolar_distance", "symmetric_epipolar_distance"):
        close(getattr(ttv, name)(T(E), T(un), T(vn)),
              getattr(jtv, name)(J(E), J(un), J(vn)), 1e-7, 1e-4)
    H = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0], [1e-5, 2e-5, 1.0]])
    u = sc["u"]
    close(ttv.symmetric_transfer_error(T(H), T(u), T(u @ H[:2, :2].T)),
          jtv.symmetric_transfer_error(J(H), J(u), J(u @ H[:2, :2].T)),
          1e-3, 1e-4)
    close(ttv._cofactor(T(E)), jtv._cofactor(J(E)), 1e-7)


def test_two_view_triangulation_and_cheirality():
    sc = two_view_scene(noise=0.3, seed=4)
    ray1 = np.concatenate([sc["un"], np.ones((40, 1))], axis=1)
    ray2 = np.concatenate([sc["vn"], np.ones((40, 1))], axis=1)
    s = np.linalg.norm(sc["t"])
    for a, b in zip(ttv.triangulate_linear(T(sc["R"]), T(sc["t"] / s),
                                           T(ray1), T(ray2)),
                    jtv.triangulate_linear(J(sc["R"]), J(sc["t"] / s),
                                           J(ray1), J(ray2))):
        close(a, b, 1e-3, 1e-3)
    mask = np.arange(40) % 7 != 0
    out_t = ttv.two_view_geometry(T(sc["E"]), T(ray1), T(ray2),
                                  torch.from_numpy(mask))
    out_j = jtv.two_view_geometry(J(sc["E"]), J(ray1), J(ray2),
                                  jnp.asarray(mask))
    assert rotation_distance(out_t[0].numpy().astype(float),
                             np.asarray(out_j[0], float)) < 1e-5
    assert translation_angle(out_t[1].numpy().astype(float),
                             np.asarray(out_j[1], float)) < 1e-5
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    assert int(out_t[4]) == int(out_j[4]) == mask.sum()


# ---------------------------------------------------------------------------
# mvg/fivepoint.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["_PTS", "_VAND_INV", "_START2",
                                  "_REMIXES", "_PHI_NODES", "_B_NODES_INV",
                                  "_B_GRID", "_ZDEG", "_XYCOL"])
def test_fivepoint_tables_bitwise(name):
    a, b = getattr(tfive, name), getattr(jfive, name)
    assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_fivepoint_pencil_and_resultant():
    """C(z) from the same basis to 1e-5; the resultant's Fourier
    coefficients to 1e-4 of their scale (31 float32 determinants)."""
    sc = two_view_scene()
    A = np.asarray(jsolv._epipolar_design_rows(sc["un"][8:13],
                                               sc["vn"][8:13]))
    basis = np.linalg.svd(A)[2][-4:].reshape(4, 3, 3)
    Ct = tfive._coefficient_matrices(*T(basis).unbind(0))
    Cj = jfive._coefficient_matrices(*J(basis))
    close(Ct, Cj, 1e-5)
    gt = tfive._resultant_coeffs(Ct).numpy()
    gj = np.asarray(jfive._resultant_coeffs(Cj))
    close(gt, gj, 1e-4 * np.abs(gj).max())


def test_fivepoint_gauss_newton_jacobian():
    """The polish's Jacobian (torch.func.jacfwd under vmap) against
    jax.jacfwd of the same residual, 1e-4."""
    rs = np.random.RandomState(8)
    basis = rs.randn(3, 4, 3, 3)
    p = rs.randn(3, 3)
    from torch.func import jacfwd, vmap

    Jt = vmap(jacfwd(tfive._resid_p))(T(p), T(basis)).numpy()

    def resid_j(pp, b):
        E = pp[0] * b[0] + pp[1] * b[1] + pp[2] * b[2] + b[3]
        return jfive._constraints(E / jnp.maximum(jnp.linalg.norm(E), 1e-12))

    Jj = np.asarray(jax.vmap(jax.jacfwd(resid_j))(J(p), J(basis)))
    close(Jt, Jj, 1e-4, 1e-4)


def test_fivepoint_solution_sets():
    """Every oracle solution (scripts/mc_fivepoint.py) that the reference
    finds, the port finds too, with min(|E - F|, |E + F|) < 1e-3 (the
    Monte-Carlo test's rule), and both recover the true E; a batch solves
    as one call. The port solves in float64 from float32 inputs, so the
    reference gets the same float32 values as float64 arrays. (The
    reference's extra valid candidates, when it has more than the oracle,
    are near-solutions that pass its 1e-3 constraint filter.)"""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from mc_fivepoint import oracle_solutions

    scenes = [two_view_scene(seed=s) for s in range(5)]
    U = f32(np.stack([sc["un"][8:13] for sc in scenes]))
    V = f32(np.stack([sc["vn"][8:13] for sc in scenes]))
    Et, vt = tfive.five_point_essential(T(U), T(V))
    assert Et.shape == (5, 10, 3, 3) and vt.shape == (5, 10)
    assert Et.dtype == torch.float32
    for k, sc in enumerate(scenes):
        Ej, vj = jfive.five_point_essential(jnp.asarray(U[k], jnp.float64),
                                            jnp.asarray(V[k], jnp.float64))
        ours = [Et[k, i].numpy() for i in range(10) if vt[k, i]]
        theirs = [np.asarray(Ej[i]) for i in range(10) if vj[i]]
        oracle = oracle_solutions(U[k].astype(float), V[k].astype(float))
        assert oracle
        for E in oracle:
            if nearest(E, theirs) < 1e-3:
                assert nearest(E, ours) < 1e-3
        assert nearest(sc["E"], ours) < 1e-3
        assert nearest(sc["E"], theirs) < 1e-3


def test_fivepoint_monte_carlo_recovery_float32():
    """Recovery of the oracle's essential matrices (scripts/mc_fivepoint.py:
    the same pencil solved as a generalized eigenproblem) by the port on
    float32 inputs: >= 99% generic, >= 97% near-planar, the reference's
    gate. (The reference meets it in float64 only: on these 256 problems
    in float32 it recovers 807/824 generic and 302/317 near-planar, so the
    port solves in float64.)"""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from mc_fivepoint import make_problem, oracle_solutions

    rs = np.random.RandomState(42)
    probs, kinds = [], []
    for i in range(256):
        planar = i % 3 == 0
        probs.append(make_problem(rs, near_planar=planar))
        kinds.append("planar" if planar else "generic")
    Es, valids = tfive.five_point_essential(
        T(np.stack([p[0] for p in probs])), T(np.stack([p[1] for p in probs])))
    Es, valids = Es.numpy().astype(np.float64), valids.numpy()
    stats = {"generic": [0, 0], "planar": [0, 0]}
    for k, (u, v, _) in enumerate(probs):
        ours = [Es[k][i] for i in range(Es.shape[1]) if valids[k][i]]
        for E in oracle_solutions(u, v):
            s = stats[kinds[k]]
            s[0] += 1
            s[1] += bool(ours) and nearest(E, ours) < 1e-3
    gen, pla = stats["generic"], stats["planar"]
    assert gen[1] / gen[0] >= 0.99, f"generic recovery {gen[1]}/{gen[0]}"
    assert pla[1] / pla[0] >= 0.97, f"planar recovery {pla[1]}/{pla[0]}"


# ---------------------------------------------------------------------------
# mvg/p3p.py
# ---------------------------------------------------------------------------

def test_p3p_matches_reference():
    """Every valid reference pose has a valid port pose within 2e-3
    (rotation angle + translation), over 12 random instances solved as
    one batch. In float32 each side's poses sit up to ~1e-3 from the
    ground truth (the eigh split of the near-singular quadric), so 2e-3
    bounds their difference."""
    rs = np.random.RandomState(9)
    Xs, rays, gts = [], [], []
    while len(Xs) < 12:
        X = rs.uniform(-2, 2, (3, 3)) + np.array([0, 0, 6.0])
        R_gt, t_gt = make_relative_motion(*rs.uniform(-0.5, 0.5, 3),
                                          t=rs.uniform(-1, 1, 3))
        Xc = X @ R_gt.T + t_gt
        if (Xc[:, 2] <= 0.1).any():
            continue
        Xs.append(X)
        rays.append(Xc / np.linalg.norm(Xc, axis=1, keepdims=True))
        gts.append(R_gt)
    Rt, tt, vt = tp3p.p3p_lambda_twist(T(np.stack(Xs)), T(np.stack(rays)))
    assert Rt.shape == (12, 4, 3, 3) and vt.shape == (12, 4)
    for k in range(12):
        Rj, tj, vj = jp3p.p3p_lambda_twist(J(Xs[k]), J(rays[k]))
        mine = [(Rt[k, i].numpy().astype(float), tt[k, i].numpy())
                for i in range(4) if vt[k, i]]
        assert min(rotation_distance(R, gts[k]) for R, _ in mine) < 2e-3
        for i in range(4):
            if vj[i]:
                assert min(rotation_distance(R, np.asarray(Rj[i], float))
                           + np.abs(t - np.asarray(tj[i])).max()
                           for R, t in mine) < 2e-3


def test_p3p_non_finite_sample_is_invalid_not_an_error():
    """A sample whose quadric is not finite comes out invalid on both sides
    (the reference's eigh returns NaN; the port's would raise), and the
    other samples of the batch are untouched."""
    rs = np.random.RandomState(3)
    X = rs.uniform(-2, 2, (2, 3, 3)) + np.array([0, 0, 6.0])
    rays = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X[1, 0, 0] = np.nan
    Rt, tt, vt = tp3p.p3p_lambda_twist(T(X), T(rays))
    _, _, vj = jp3p.p3p_lambda_twist(J(X[1]), J(rays[1]))
    assert not vt[1].any() and not np.asarray(vj).any()
    assert vt[0].any()
    R1, t1, v1 = tp3p.p3p_lambda_twist(T(X[:1]), T(rays[:1]))
    assert torch.equal(v1, vt[:1])
    assert torch.equal(R1[v1], Rt[:1][v1])


# ---------------------------------------------------------------------------
# mvg/degeneracy.py and mvg/extra_solvers.py
# ---------------------------------------------------------------------------

def _plane_and_generic_scenes():
    rs = np.random.RandomState(5)
    ang = 0.2
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([1.0, 0.2, 0.1])

    def project_pair(X):
        Xb = X @ R.T + t
        return X[:, :2] / X[:, 2:], Xb[:, :2] / Xb[:, 2:]

    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    n_vec = np.array([0.1, 0.3, 1.0])
    Xp = rs.uniform(-2, 2, (60, 3)) + np.array([0, 0, 6.0])
    Xp = Xp * (6.0 / (Xp @ n_vec))[:, None]
    Xg = rs.uniform(-2, 2, (60, 3)) + np.array([0, 0, 6.0])
    return tx @ R, project_pair(Xp), project_pair(Xg)


def test_degeneracy_plane_homography():
    """homography_from_epipolar from the same triple: the plane's H to
    1e-3 after normalization; the epipoles to 1e-5 after a sign fix."""
    E, (up, vp), _ = _plane_and_generic_scenes()
    for a, b in zip(tdeg.epipoles(T(E)), jdeg.epipoles(J(E))):
        close(sign_fixed(a.numpy()[None]), sign_fixed(np.asarray(b)[None]),
              1e-5)
    tri = [3, 17, 41]
    Ht = tdeg.homography_from_epipolar(T(E), T(up[tri]), T(vp[tri]))
    Hj = jdeg.homography_from_epipolar(J(E), J(up[tri]), J(vp[tri]))
    close(sign_fixed(Ht), sign_fixed(Hj), 1e-3)
    close(tdeg.homography_transfer_error(Ht, T(up), T(vp)),
          jdeg.homography_transfer_error(Hj, J(up), J(vp)), 1e-4)


def test_degeneracy_dominant_plane_ratio():
    """Draws differ (generator vs key), so outcomes are compared: the
    reference's test thresholds hold on both sides."""
    E, (up, vp), (ug, vg) = _plane_and_generic_scenes()
    mask = np.ones(60, bool)
    for u, v, planar in ((up, vp, True), (ug, vg, False)):
        rt = float(tdeg.dominant_plane_ratio(
            T(E), T(u), T(v), torch.from_numpy(mask), threshold=0.01,
            generator=torch.Generator().manual_seed(0)))
        rj = float(jdeg.dominant_plane_ratio(J(E), J(u), J(v),
                                             jnp.asarray(mask),
                                             threshold=0.01))
        if planar:
            assert rt > 0.9 and rj > 0.9
        else:
            assert rt < 0.6 and rj < 0.6


def test_extra_solvers():
    rs = np.random.RandomState(0)
    R, t_gt = make_relative_motion()
    X = rs.uniform(-2, 2, (5, 3)) + np.array([0, 0, 8.0])
    Xc = X @ R.T + t_gt
    rays = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    close(textra.absolute_translation(T(R), T(X), T(rays)),
          jextra.absolute_translation(J(R), J(X), J(rays)), 1e-4)
    p = np.tile([40.0, 60.0], (8, 1))
    q = rs.uniform(0, 100, (8, 2))
    lt = textra.line_through(T(p), T(q))
    close(lt, jextra.line_through(J(p), J(q)), 1e-3, 1e-6)
    vt = textra.vanishing_point_from_lines(lt).numpy()
    vj = np.asarray(jextra.vanishing_point_from_lines(J(lt.numpy())))
    close(vt[:2] / vt[2], vj[:2] / vj[2], 1e-3)
    close(vt[:2] / vt[2], [40.0, 60.0], 1e-2)
