"""Port parity: bundle adjustment (``ba/jacobian.py``, ``ba/core.py``,
``ba/dense_schur.py``) against the ``sara_tpu`` twins.

Problems are seeded numpy arrays given to both packages. The suite's
conftest turns on JAX x64, so a float32 case casts its float arrays to
float32 on both sides explicitly (an uncast JAX problem would take the
float64 path). Tolerances are stated per test:

- float64 (nothing is cast): 1e-9 relative stage by stage;
- float32, where the dense solver works in bfloat16 with float32
  accumulation on both sides. Stage by stage the port is held to the
  reference run op by op (eagerly), to 1e-6 relative. Under ``jax.jit``
  XLA keeps some bfloat16 products in float32 inside its fusions, so the
  reference's own jitted stages differ from its eager ones by up to ~2% in
  S_pt; and S = U - W V^-1 W^T cancels most of its bfloat16 digits, so the
  LM step itself moves by tens of percent with such roundings (one
  iteration from the same start lowered the cost to 103.3 in the jitted
  reference and to 151.6 in the port). A whole float32 iteration is
  therefore held to being accepted on both sides, and float32 end-to-end
  runs pin the monocular scale (one translation component of camera 1, as
  the odometry pipeline does) and are held by final cost and poses.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu.ba import BAOptions as JOptions
from sara_tpu.ba import BAProblem as JProblem
from sara_tpu.ba import DenseSchurSession as JSession
from sara_tpu.ba import bundle_adjust as jbundle_adjust
from sara_tpu.ba import bundle_adjust_cg as jbundle_adjust_cg
from sara_tpu.ba import core as jcore
from sara_tpu.ba import dense_schur as jds
from sara_tpu.ba import jacobian as jjac
from sara_tpu_torch.ba import BAOptions, DenseSchurSession, bundle_adjust
from sara_tpu_torch.ba import bundle_adjust_cg
from sara_tpu_torch.ba import core as tcore
from sara_tpu_torch.ba import dense_schur as tds
from sara_tpu_torch.ba import jacobian as tjac
from sara_tpu_torch.convert import ba_problem_from_numpy, params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_ba import _make_ba_problem  # noqa: E402

FLOAT_FIELDS = ("poses", "points", "intrinsics", "uv")


def host(prob):
    """The problem's fields as numpy arrays (None stays None)."""
    return [None if f is None else np.asarray(f) for f in prob]


def cast(prob, dtype):
    """A JAX problem with its float fields cast to ``dtype``."""
    return prob._replace(**{k: jnp.asarray(np.asarray(getattr(prob, k)),
                                           dtype) for k in FLOAT_FIELDS})


def pair(prob):
    """(JAX problem, port problem on the CPU) with the same arrays."""
    return prob, ba_problem_from_numpy(host(prob), "cpu")


def rel_err(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def random_poses_points(rs, O=40):
    poses = np.concatenate([rs.normal(scale=0.3, size=(O, 3)),
                            rs.normal(scale=0.5, size=(O, 3))], 1)
    X = rs.uniform(-2, 2, (O, 3)) + np.array([0, 0, 8.0])
    uv = rs.uniform(0, 640, (O, 2))
    return poses, X, uv


# ---------------------------------------------------------------------------
# Jacobians
# ---------------------------------------------------------------------------

def test_pinhole_jacobians_match_jax_and_jacfwd():
    rs = np.random.RandomState(0)
    O = 40
    poses, X, uv = random_poses_points(rs, O)
    poses[0, :3] = 0.0                      # the small-angle branch
    intr = np.array([500.0, 480.0, 320.0, 240.0])
    cam = np.arange(O, dtype=np.int32)
    pt = rs.permutation(O).astype(np.int32)
    ref = jjac.pinhole_jacobians(*(jnp.asarray(a) for a in
                                   (poses, X, intr, cam, pt, uv)))
    got = tjac.pinhole_jacobians(*(torch.from_numpy(a) for a in
                                   (poses, X, intr, cam, pt, uv)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert rel_err(g.numpy(), r) <= 1e-12
    # The residual-only path (the dense solver's cost) gives the same r.
    args = [torch.from_numpy(a) for a in
            (poses[cam, :3], poses[cam, 3:], X[pt], intr, uv)]
    assert torch.equal(tjac.pinhole_residuals_gathered(*args),
                       tjac.pinhole_jacobians_gathered(*args)[0])

    # Against forward-mode autodiff of the port's own projection.
    from torch.func import jacfwd, vmap

    T = lambda a: torch.from_numpy(a)  # noqa: E731

    def res(pose6, Xp, uvp):
        return tcore._project(T(intr), pose6, Xp)[0] - uvp

    p_o, X_o, uv_o = T(poses)[cam.astype(np.int64)], T(X)[pt], T(uv)
    Jc = vmap(jacfwd(res, argnums=0))(p_o, X_o, uv_o)
    Jp = vmap(jacfwd(res, argnums=1))(p_o, X_o, uv_o)
    r, Jcf, Jpf = got
    assert rel_err(Jcf.reshape(O, 2, 6), Jc) <= 1e-9
    assert rel_err(Jpf.reshape(O, 2, 3), Jp) <= 1e-9
    assert rel_err(r, res(p_o, X_o, uv_o)) <= 1e-12


@pytest.mark.parametrize("case", ["brown_conrady", "intr_free"])
def test_autodiff_jacobians_match_jax(case):
    """``_jacobians`` (torch.func.jacfwd under vmap) against jax.jacfwd
    under vmap: the Brown-Conrady (8,) residual, and optimizable pinhole
    intrinsics with a partial free mask; float64, 1e-10 relative."""
    prob, *_ = _make_ba_problem(n_cams=3, n_pts=20, seed=1)
    if case == "brown_conrady":
        intr = np.r_[np.asarray(prob.intrinsics), 0.05, -0.01, 1e-3, -2e-3]
        prob = prob._replace(intrinsics=jnp.asarray(intr))
    else:
        prob = prob._replace(intr_free=jnp.asarray([True, True, False,
                                                    True]))
    pf = np.zeros((3, 6), bool)
    pf[0] = True
    pf[1, 4] = True
    ptf = np.zeros(prob.points.shape[0], bool)
    ptf[::5] = True
    prob = prob._replace(pose_fixed=jnp.asarray(pf),
                         point_fixed=jnp.asarray(ptf))
    jp, tp = pair(prob)
    ref = jcore._jacobians(jp, 4.0, 6.0)
    got = tcore._jacobians(tp, 4.0, 6.0)
    assert (got[3] is None) == (ref[3] is None) == (case == "brown_conrady")
    for g, r in zip(got, ref):
        if r is not None:
            assert g.shape == r.shape
            assert rel_err(g.numpy(), r) <= 1e-10


# ---------------------------------------------------------------------------
# Point-major packing
# ---------------------------------------------------------------------------

def _long_tail_problem(seed=3, C=12, P=300):
    """Observations per point drawn from a long tail (1 .. C), so the
    stratified packing makes several strata."""
    rs = np.random.RandomState(seed)
    counts = np.minimum(1 + rs.geometric(0.35, P), C)
    cam = np.concatenate([rs.choice(C, n, replace=False) for n in counts])
    pt = np.repeat(np.arange(P), counts)
    order = rs.permutation(len(pt))
    cam, pt = cam[order].astype(np.int32), pt[order].astype(np.int32)
    O = len(pt)
    mask = rs.rand(O) > 0.1
    return JProblem(
        poses=jnp.asarray(rs.normal(scale=0.1, size=(C, 6))),
        points=jnp.asarray(rs.normal(size=(P, 3)) + [0, 0, 10.0]),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0]),
        cam_idx=jnp.asarray(cam), pt_idx=jnp.asarray(pt),
        uv=jnp.asarray(rs.uniform(0, 640, (O, 2))),
        obs_mask=jnp.asarray(mask),
        pose_fixed=jnp.asarray(np.arange(C) == 0),
        point_fixed=jnp.asarray(rs.rand(P) < 0.05))


def _same_ptm(t, j):
    for name in jds.PtMajorBA._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        a = a.numpy()
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("chunk", [16384, 128])
def test_pack_pt_major_bitwise(chunk):
    jp, tp = pair(_long_tail_problem())
    jptm, jst = jds.pack_pt_major(jp, chunk=chunk)
    tptm, tst = tds.pack_pt_major(tp, chunk=chunk)
    assert tst == jst
    _same_ptm(tptm, jptm)


@pytest.mark.parametrize("min_stratum", [4096, 16])
def test_pack_pt_major_strata_bitwise(min_stratum):
    jp, tp = pair(_long_tail_problem())
    js, jids, jst = jds.pack_pt_major_strata(jp, chunk=128,
                                             min_stratum=min_stratum)
    ts, tids, tst = tds.pack_pt_major_strata(tp, chunk=128,
                                             min_stratum=min_stratum)
    assert tst == jst
    assert len(ts) == len(js) == len(tids) == len(jids)
    assert (len(ts) > 1) == (min_stratum == 16)
    for a, b, ia, ib in zip(ts, js, tids, jids):
        _same_ptm(a, b)
        assert np.array_equal(ia, ib)
        assert a.poses is ts[0].poses           # one shared poses tensor


# ---------------------------------------------------------------------------
# One LM step of the dense path, stage by stage
# ---------------------------------------------------------------------------

STAGE_TOL = {"float64": (1e-9, 1e-9), "float32": (1e-6, 1e-4)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_lm_step_stage_by_stage(dtype):
    """Ucat, S_pt and rhs_pt of every chunk, the camera step dc6, and the
    back-substituted point step dp, each fed the reference's own inputs;
    then one whole LM iteration. The float32 case runs the bfloat16 path on
    both sides."""
    tol_sum, tol_step = STAGE_TOL[dtype]
    prob, *_ = _make_ba_problem(n_cams=5, n_pts=80, seed=2)
    prob = cast(prob, getattr(jnp, dtype))
    jp, tp = pair(prob)
    jptm, st = jds.pack_pt_major(jp, chunk=32)
    tptm, _ = tds.pack_pt_major(tp, chunk=32)
    Q = st["chunk"]
    assert jptm.points.shape[0] // Q >= 2      # several chunks
    dt = getattr(np, dtype)
    lam = dt(1e-3)
    delta, cutoff = 4.0, 6.0

    def chunks(ptm):
        a = [np.array(x) for x in (ptm.points, ptm.cam_idx, ptm.uv,
                                   ptm.slot_mask, ptm.point_fixed)]
        return [tuple(x[i:i + Q] for x in a)
                for i in range(0, a[0].shape[0], Q)]

    pts_q, cam_q, uv_q, m_q, fix_q = (torch.from_numpy(x)
                                      for x in chunks(jptm)[0])
    r, Jcf, Jpf = tds._slot_residual_jac(tp.poses, pts_q, tp.intrinsics,
                                         cam_q, uv_q, m_q, fix_q, delta,
                                         cutoff)
    wd = torch.bfloat16 if dtype == "float32" else torch.float64
    assert r.dtype == Jcf.dtype == Jpf.dtype == wd

    acc_j = acc_t = None
    for ch in chunks(jptm):
        ref = jds._chunk_stats(jptm.poses, jptm.intrinsics, jptm.pose_free,
                               jnp.asarray(lam), tuple(jnp.asarray(x)
                                                       for x in ch),
                               delta, cutoff)
        got = tds._chunk_stats(tptm.poses, tptm.intrinsics, tptm.pose_free,
                               torch.tensor(lam), tuple(torch.from_numpy(x)
                                                        for x in ch),
                               delta, cutoff)
        for name, g, r in zip(("Ucat", "S_pt", "rhs_pt"), got, ref):
            assert g.dtype == torch.float64 if dtype == "float64" else \
                g.dtype == torch.float32, name
            assert rel_err(g.numpy(), r) <= tol_sum, name
        acc_j = ref if acc_j is None else tuple(a + b for a, b in
                                                zip(acc_j, ref))
        acc_t = got if acc_t is None else tuple(a + b for a, b in
                                                zip(acc_t, got))

    # dc6 from the reference's accumulated system, the reference's
    # formula (dense_schur.py:473-481) restated on jnp.
    Ucat, S_pt, rhs_pt = (np.asarray(a) for a in acc_j)
    C = Ucat.shape[0]
    U = Ucat[:, :36].reshape(C, 6, 6)
    d6 = np.eye(6, dtype=dt)
    U_d = U + lam * U * d6 + 1e-8 * d6
    S = (np.einsum("cd,cji->jcid", np.eye(C, dtype=dt), U_d)
         .reshape(6 * C, 6 * C) - S_pt)
    rhs = (-Ucat[:, 36:] - rhs_pt).T.reshape(6 * C)
    ref_dc6 = np.asarray(jnp.linalg.solve(jnp.asarray(S), jnp.asarray(rhs))
                         ).reshape(6, C).T * np.asarray(jptm.pose_free)
    dc6 = tds._solve_cameras(*(torch.from_numpy(np.asarray(a)) for a in
                               acc_j), torch.tensor(lam), tptm.pose_free)
    assert rel_err(dc6.numpy(), ref_dc6) <= tol_step

    # dp per chunk, both sides fed the reference's dc6.
    for ch in chunks(jptm):
        ref = jds._chunk_backsub(jptm.poses, jptm.intrinsics,
                                 jptm.pose_free, jnp.asarray(ref_dc6),
                                 jnp.asarray(lam),
                                 tuple(jnp.asarray(x) for x in ch), delta,
                                 cutoff)
        got = tds._chunk_backsub(tptm.poses, tptm.intrinsics,
                                 tptm.pose_free, torch.from_numpy(ref_dc6),
                                 torch.tensor(lam),
                                 tuple(torch.from_numpy(x) for x in ch),
                                 delta, cutoff)
        assert rel_err(got.numpy(), ref) <= tol_step

    # One whole LM iteration against the jitted reference: accepted on both
    # sides, and in float64 the same step (module docstring for float32).
    opts = BAOptions(max_iters=1)
    jposes, jpts, jinfo = jds.dense_schur_bundle_adjust(
        jptm, JOptions(max_iters=1), Q)
    tposes, tpts, tinfo = tds.dense_schur_bundle_adjust(tptm, opts, Q)
    assert float(jinfo["final_cost"]) < float(jinfo["initial_cost"])
    assert float(tinfo["final_cost"]) < float(tinfo["initial_cost"])
    assert rel_err(tinfo["initial_cost"], jinfo["initial_cost"]) <= (
        1e-12 if dtype == "float64" else 1e-6)
    if dtype == "float64":
        step_j = np.asarray(jposes) - np.asarray(jptm.poses)
        step_t = tposes.numpy() - tptm.poses.numpy()
        assert rel_err(step_t, step_j) <= tol_step
        assert rel_err(tpts.numpy() - tptm.points.numpy(),
                       np.asarray(jpts) - np.asarray(jptm.points)) <= tol_step



# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver,dtype", [
    ("dense", "float64"), ("dense", "float32"), ("cg", "float64"),
    ("cg", "float32")])
def test_bundle_adjust_end_to_end(solver, dtype):
    """The JAX BA test problem (4 cameras, 60 points, 0.5 px noise, 6 bad
    observations) through ``bundle_adjust`` with the given solver on both
    sides: final costs within 1e-6 relative and poses within 1e-6 in
    float64; in float32, with the scale pinned (module docstring), costs
    within 1e-3 and poses within 5e-3."""
    prob, *_ = _make_ba_problem(n_bad_obs=6)
    if dtype == "float32":
        pf = np.zeros((4, 6), bool)
        pf[0] = True
        pf[1, 3] = True
        prob = prob._replace(pose_fixed=jnp.asarray(pf))
    prob = cast(prob, getattr(jnp, dtype))
    jp, tp = pair(prob)
    jo = JOptions(max_iters=15, cg_iters=20, solver=solver)
    to = params_from_jax(jo)
    run_j = jbundle_adjust if solver == "dense" else jbundle_adjust_cg
    run_t = bundle_adjust if solver == "dense" else bundle_adjust_cg
    jout, jinfo = run_j(jp, jo)
    tout, tinfo = run_t(tp, to)
    assert tout.poses.dtype == getattr(torch, dtype)
    assert tinfo["costs"].shape == (15,)
    f_j, f_t = float(jinfo["final_cost"]), float(tinfo["final_cost"])
    assert f_t < 0.5 * float(tinfo["initial_cost"])
    tol_cost, tol_pose = (1e-6, 1e-6) if dtype == "float64" else (1e-3, 5e-3)
    assert abs(f_t - f_j) <= tol_cost * f_j
    np.testing.assert_allclose(tout.poses.numpy(), np.asarray(jout.poses),
                               atol=tol_pose)
    np.testing.assert_allclose(tout.points.numpy(), np.asarray(jout.points),
                               atol=10 * tol_pose)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_freezes_hold(solver):
    """(C,) and (C, 6) pose freezes and point freezes leave the frozen values
    bitwise unchanged, and the port agrees with the reference (float64)."""
    prob, *_ = _make_ba_problem(n_cams=5, n_pts=60, seed=4)
    pf = np.zeros((5, 6), bool)
    pf[0] = True
    pf[1, 3] = True                         # one translation component
    ptf = np.zeros(60, bool)
    ptf[::7] = True
    for pose_fixed in (np.arange(5) < 2, pf):
        jp, tp = pair(prob._replace(pose_fixed=jnp.asarray(pose_fixed),
                                    point_fixed=jnp.asarray(ptf)))
        jo = JOptions(max_iters=8, solver=solver)
        jout, _ = (jbundle_adjust if solver == "dense"
                   else jbundle_adjust_cg)(jp, jo)
        tout, _ = (bundle_adjust if solver == "dense"
                   else bundle_adjust_cg)(tp, params_from_jax(jo))
        frozen = np.broadcast_to(
            pose_fixed if pose_fixed.ndim == 2 else pose_fixed[:, None],
            (5, 6))
        assert np.array_equal(tout.poses.numpy()[frozen],
                              np.asarray(prob.poses)[frozen])
        assert np.array_equal(tout.points.numpy()[ptf],
                              np.asarray(prob.points)[ptf])
        assert (tout.poses.numpy()[~frozen]
                != np.asarray(prob.poses)[~frozen]).all()
        np.testing.assert_allclose(tout.poses.numpy(),
                                   np.asarray(jout.poses), atol=1e-7)


def test_dense_schur_session_matches_one_shot():
    """A session solve equals the one-shot dense call; a second solve
    continues from the first; swapped-in values re-run from them; the
    shared-poses invariant is checked."""
    prob, *_ = _make_ba_problem(n_cams=4, n_pts=60, seed=5)
    jp, tp = pair(prob)
    opts = BAOptions(max_iters=4, solver="dense")
    one, info1 = bundle_adjust(tp, opts)
    sess = DenseSchurSession(tp, opts)
    assert sess.eligible
    poses, points, info = sess.solve()
    np.testing.assert_array_equal(poses.numpy(), one.poses.numpy())
    np.testing.assert_array_equal(points.numpy(), one.points.numpy())
    assert float(info["final_cost"]) == float(info1["final_cost"])
    # The reference's session, the same calls (float64, 1e-8).
    jsess = JSession(jp, JOptions(max_iters=4, solver="dense"))
    jposes, jpoints, _ = jsess.solve()
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-8)
    # Chained: the second solve starts where the first ended.
    _, _, info2 = sess.solve()
    assert float(info2["initial_cost"]) == float(info["final_cost"])
    assert float(info2["final_cost"]) <= float(info["final_cost"])
    # Swapped-in values: back to the starting problem.
    p3, x3, info3 = sess.solve(poses=tp.poses, points=tp.points)
    np.testing.assert_allclose(p3.numpy(), poses.numpy(), atol=1e-12)
    assert float(info3["initial_cost"]) == float(info1["initial_cost"])
    # The invariant: strata that stop sharing one poses tensor are refused.
    first = sess.strata[0]
    sess.strata = (first, first._replace(poses=first.poses.clone()))
    with pytest.raises(AssertionError, match="poses"):
        sess.solve(points=tp.points)


def test_session_invariant_checked_at_construction(monkeypatch):
    prob, *_ = _make_ba_problem(n_cams=3, n_pts=20, seed=6)
    _, tp = pair(prob)
    real = tds.pack_pt_major_strata

    def split(p, **kw):
        strata, ids, stats = real(p, **kw)
        return ([s._replace(poses=s.poses.clone()) for s in strata * 2],
                ids * 2, stats)

    monkeypatch.setattr(tds, "pack_pt_major_strata", split)
    with pytest.raises(AssertionError, match="poses"):
        DenseSchurSession(tp, BAOptions())


def test_degenerate_problem_is_a_noop():
    prob, *_ = _make_ba_problem(n_cams=3, n_pts=10)
    _, tp = pair(prob)
    for empty in (tp._replace(points=tp.points[:0]),
                  tp._replace(uv=tp.uv[:0], cam_idx=tp.cam_idx[:0],
                              pt_idx=tp.pt_idx[:0],
                              obs_mask=tp.obs_mask[:0])):
        out, info = bundle_adjust(empty, BAOptions(max_iters=7))
        assert out is empty
        assert float(info["final_cost"]) == 0.0
        assert info["costs"].shape == (7,)
        assert float(info["lambda"]) == pytest.approx(1e-3)


def test_cost_projection_and_conversion():
    """ba_cost / project_obs parity (float64), and the converters keep
    dtypes, field values and a None ``intr_free``."""
    prob, *_ = _make_ba_problem(n_bad_obs=4)
    jp, tp = pair(prob)
    assert tp.intr_free is None and tp.poses.dtype == torch.float64
    assert tp.cam_idx.dtype == torch.int32 and tp.obs_mask.dtype == torch.bool
    for cutoff in (np.inf, 6.0):
        assert rel_err(tcore.ba_cost(tp, 4.0, cutoff),
                       jcore.ba_cost(jp, 4.0, cutoff)) <= 1e-12
    pred, depth = tcore.project_obs(tp)
    jpred, jdepth = jcore.project_obs(jp)
    assert rel_err(pred, jpred) <= 1e-12 and rel_err(depth, jdepth) <= 1e-12
    jo = JOptions(max_iters=3, solver="cg", outlier_cutoff=np.inf)
    assert params_from_jax(jo)._asdict() == jo._asdict()
    with_free = ba_problem_from_numpy(
        host(prob._replace(intr_free=jnp.ones(4, bool))), "cpu")
    assert with_free.intr_free.dtype == torch.bool
    with pytest.raises(ValueError):
        ba_problem_from_numpy(host(prob)[:5], "cpu")
