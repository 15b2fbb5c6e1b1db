"""Port parity: Slice B's RANSAC engine, estimators and ORSA, and the slice
end to end.

``torch.Generator`` draws cannot reproduce ``jax.random`` draws, so parity
tests take the JAX package's own sample indices (``draw_samples`` with the
reference's key) and hand them to the port by monkeypatching the port's
``draw_samples``; the port's API has no test-only argument. Where the draws
differ (the port's own generator), outcomes are compared instead: rotation
and translation angle errors and inlier counts on the synthetic scenes of
``tests/geometry_fixtures.py``. Inputs are float32 on both sides.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.ransac import engine as jengine
from sara_tpu.ransac import estimators as jest
from sara_tpu.ransac import orsa as jorsa
from sara_tpu.mvg.solvers import four_point_homography as j4pt
from sara_tpu.mvg.two_view import symmetric_transfer_error as jste
from sara_tpu_torch.mvg.solvers import four_point_homography as t4pt
from sara_tpu_torch.mvg.two_view import symmetric_transfer_error as tste
from sara_tpu_torch.ransac import engine as tengine
from sara_tpu_torch.ransac import estimators as test_
from sara_tpu_torch.ransac import orsa as torsa

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


def inject(monkeypatch, key, num_samples, sample_size, mask):
    """Make the port draw the reference's samples for this key."""
    idx, ok = jengine.draw_samples(key, num_samples, sample_size,
                                   jnp.asarray(mask))
    drawn = (torch.from_numpy(np.asarray(idx, np.int64)),
             torch.from_numpy(np.asarray(ok)))
    monkeypatch.setattr(tengine, "draw_samples", lambda *a: drawn)
    return drawn


def plane_pair(seed=1, n=100, n_out=30, noise=0.3):
    rs = np.random.RandomState(seed)
    Xp = np.concatenate([rs.uniform(-2, 2, (n, 2)), np.full((n, 1), 6.0)],
                        axis=1)
    R, t = make_relative_motion()
    u, _ = project(default_K(), np.eye(3), np.zeros(3), Xp)
    v, _ = project(default_K(), R, t, Xp)
    v += rs.normal(scale=noise, size=v.shape)
    out = rs.choice(n, n_out, replace=False)
    v[out] = rs.uniform(0, 800, (n_out, 2))
    true_inl = np.ones(n, bool)
    true_inl[out] = False
    return u, v, true_inl


def pnp_scene(seed=11, n=120, n_out=30):
    rs = np.random.RandomState(seed)
    X = rs.uniform(-3, 3, (n, 3)) + np.array([0, 0, 8.0])
    K = default_K()
    R_gt, t_gt = make_relative_motion(0.2, -0.1, 0.15, t=(0.5, -0.2, 0.3))
    uv, _ = project(K, R_gt, t_gt, X)
    uv += rs.normal(scale=0.3, size=uv.shape)
    out = rs.choice(n, n_out, replace=False)
    uv[out] = rs.uniform(0, 768, (n_out, 2))
    ph = np.concatenate([uv, np.ones((n, 1))], axis=1) @ np.linalg.inv(K).T
    rays = ph / np.linalg.norm(ph, axis=1, keepdims=True)
    return X, rays, uv, K, R_gt, t_gt


def corners_moved(H, w=1024.0, h=768.0):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], float)
    p = c @ np.asarray(H, float).T
    return p[:, :2] / p[:, 2:]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio,k,conf", [(0.5, 4, 0.99), (0.3, 5, 0.999),
                                          (0.9, 7, 0.99)])
def test_ransac_num_samples(ratio, k, conf):
    assert tengine.ransac_num_samples(ratio, k, conf) == \
        jengine.ransac_num_samples(ratio, k, conf)


def test_draw_samples():
    """Valid rows only, duplicates flagged, the generator decides."""
    mask = torch.from_numpy(np.arange(50) % 3 != 0)
    g = torch.Generator().manual_seed(7)
    idx, ok = tengine.draw_samples(g, 400, 5, mask)
    assert idx.shape == (400, 5) and ok.shape == (400,)
    assert bool(mask[idx].all())
    dup = torch.tensor([len(set(r.tolist())) < 5 for r in idx])
    assert torch.equal(~dup, ok)
    again, _ = tengine.draw_samples(torch.Generator().manual_seed(7), 400, 5,
                                    mask)
    assert torch.equal(idx, again)
    idx0, _ = tengine.draw_samples(g, 10, 4, torch.zeros(50, dtype=torch.bool))
    assert idx0.shape == (10, 4)                 # all-False mask: no error


def test_engine_with_the_reference_samples(monkeypatch):
    """The generic engine on a homography problem with the reference's
    draws: the same best count and inlier set, and the port's model is,
    to 1e-3 relative, one of the reference's hypotheses with that count
    (several hypotheses tie; float32 residuals at the threshold decide
    which comes first)."""
    u, v, _ = plane_pair()
    u, v = (u - 512.0) / 400.0, (v - 512.0) / 400.0   # a well-posed DLT
    thr = 2.0 / 400.0
    mask = np.ones(100, bool)
    key = jax.random.PRNGKey(0)
    ref = jengine.ransac(
        key, (J(u), J(v)), jnp.asarray(mask),
        lambda s: j4pt(*s), lambda H, d: jste(H, *d),
        sample_size=4, num_samples=200, threshold=thr, min_inliers=10)
    inject(monkeypatch, key, 200, 4, mask)
    out = tengine.ransac(
        torch.Generator(), (T(u), T(v)), torch.from_numpy(mask),
        lambda s: t4pt(*s), lambda H, d: tste(H, *d),
        sample_size=4, num_samples=200, threshold=thr, min_inliers=10)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.num_inliers) == int(ref.num_inliers)
    assert bool(out.success) and bool(ref.success)
    idx, _ = tengine.draw_samples()
    Hs, _ = jax.vmap(j4pt)(J(u)[idx.numpy()], J(v)[idx.numpy()])
    counts = np.asarray(jax.vmap(lambda H: jnp.sum(jste(H, J(u), J(v))
                                                   < thr))(Hs[:, 0]))
    best = np.asarray(Hs[:, 0])[counts == counts.max()]
    H = out.model.numpy()
    assert counts.max() == int(ref.num_inliers)
    assert min(np.abs(H - B).max() / np.abs(B).max() for B in best) < 1e-3


# ---------------------------------------------------------------------------
# estimators, with the reference's draws
# ---------------------------------------------------------------------------

def test_estimate_homography_parity(monkeypatch):
    """Same inliers; corners moved by H agree within 0.05 px."""
    u, v, true_inl = plane_pair()
    mask = np.ones(100, bool)
    key = jax.random.PRNGKey(0)
    ref = jest.estimate_homography(key, J(u), J(v), jnp.asarray(mask),
                                   threshold=2.0, num_samples=300)
    inject(monkeypatch, key, 300, 4, mask)
    out = test_.estimate_homography(torch.Generator(), T(u), T(v),
                                    torch.from_numpy(mask), threshold=2.0,
                                    num_samples=300)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert bool(out.success)
    assert np.abs(corners_moved(out.model.numpy())
                  - corners_moved(np.asarray(ref.model))).max() < 0.05
    assert (out.inliers.numpy() & ~true_inl).sum() == 0


def test_estimate_fundamental_parity(monkeypatch):
    """Inlier sets within 1% of each other; Sampson residuals of the two
    models on the true inliers within 1e-5 (normalized units)."""
    sc = two_view_scene(n_points=150, noise=0.0, n_outliers=40, seed=5)
    mask = np.ones(150, bool)
    key = jax.random.PRNGKey(1)
    thr = 2.0 / 800.0
    ref = jest.estimate_fundamental(key, J(sc["un"]), J(sc["vn"]),
                                    jnp.asarray(mask), threshold=thr,
                                    num_samples=300)
    inject(monkeypatch, key, 300, 7, mask)
    out = test_.estimate_fundamental(torch.Generator(), T(sc["un"]),
                                     T(sc["vn"]), torch.from_numpy(mask),
                                     threshold=thr, num_samples=300)
    a, b = out.inliers.numpy(), np.asarray(ref.inliers)
    assert (a != b).sum() <= 0.01 * len(a)
    true_inl = np.ones(150, bool)
    true_inl[sc["outliers"]] = False
    from sara_tpu_torch.mvg.two_view import sampson_epipolar_distance as sd

    for F in (out.model, torch.from_numpy(np.asarray(ref.model))):
        r = sd(F, T(sc["un"]), T(sc["vn"])).numpy()[true_inl]
        assert r.max() < 1e-5


def test_estimate_relative_pose_parity(monkeypatch):
    """R and t within 1e-3 rad of the reference's; inlier counts within 2%
    (the port solves the 5-point problem in float64, the reference in
    float32, so the hypotheses differ in their last digits)."""
    sc = two_view_scene(n_points=200, noise=0.2, n_outliers=50, seed=7)
    mask = np.ones(200, bool)
    key = jax.random.PRNGKey(2)
    K = J(sc["K"])
    ref, Rj, tj = jest.estimate_relative_pose(
        key, J(sc["u"]), J(sc["v"]), jnp.asarray(mask), K, K,
        threshold_px=4.0, num_samples=300, min_inliers=100)
    inject(monkeypatch, key, 300, 5, mask)
    Kt = T(sc["K"])
    out, Rt, tt = test_.estimate_relative_pose(
        torch.Generator(), T(sc["u"]), T(sc["v"]), torch.from_numpy(mask),
        Kt, Kt, threshold_px=4.0, num_samples=300, min_inliers=100)
    assert bool(out.success) and bool(ref.success)
    assert rotation_distance(Rt.numpy().astype(float),
                             np.asarray(Rj, float)) < 1e-3
    assert translation_angle(tt.numpy().astype(float),
                             np.asarray(tj, float)) < 1e-3
    assert abs(int(out.num_inliers) - int(ref.num_inliers)) <= 4
    assert rotation_distance(Rt.numpy().astype(float), sc["R"]) < 0.01
    assert translation_angle(tt.numpy().astype(float), sc["t"]) < 0.02


def test_estimate_absolute_pose_parity(monkeypatch):
    """Same inliers; R within 1e-3 rad and t within 1e-2 of the
    reference's (float32 P3P)."""
    X, rays, uv, K, R_gt, t_gt = pnp_scene()
    mask = np.ones(120, bool)
    key = jax.random.PRNGKey(3)
    ref, Rj, tj = jest.estimate_absolute_pose(
        key, J(X), J(rays), J(uv), J(K), jnp.asarray(mask),
        threshold_px=5.0, num_samples=300, min_inliers=50)
    inject(monkeypatch, key, 300, 3, mask)
    out, Rt, tt = test_.estimate_absolute_pose(
        torch.Generator(), T(X), T(rays), T(uv), T(K),
        torch.from_numpy(mask), threshold_px=5.0, num_samples=300,
        min_inliers=50)
    assert bool(out.success) and bool(ref.success)
    a, b = out.inliers.numpy(), np.asarray(ref.inliers)
    assert (a != b).sum() <= 1
    assert rotation_distance(Rt.numpy().astype(float),
                             np.asarray(Rj, float)) < 1e-3
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-2
    assert rotation_distance(Rt.numpy().astype(float), R_gt) < 0.01


def test_orsa_parity(monkeypatch):
    """A-contrario selection with the reference's draws: inlier sets
    within 1 row; both succeed."""
    u, v, _ = plane_pair(seed=3, n=80, n_out=25)
    mask = np.ones(80, bool)
    key = jax.random.PRNGKey(4)
    ref = jorsa.orsa(key, (J(u), J(v)), jnp.asarray(mask),
                     lambda s: j4pt(*s), lambda H, d: jste(H, *d),
                     sample_size=4, num_samples=200, alpha0=np.pi / 1e6,
                     max_threshold=20.0)
    inject(monkeypatch, key, 200, 4, mask)
    out = torsa.orsa(torch.Generator(), (T(u), T(v)), torch.from_numpy(mask),
                     lambda s: t4pt(*s), lambda H, d: tste(H, *d),
                     sample_size=4, num_samples=200, alpha0=np.pi / 1e6,
                     max_threshold=20.0)
    assert bool(out.success) and bool(ref.success)
    a, b = out.inliers.numpy(), np.asarray(ref.inliers)
    assert (a != b).sum() <= 1
    # 1% of log10 NFA: the reference sums its log-combinations in float64
    # here (x64), and tied hypotheses may differ as in the engine test.
    assert abs(float(out.log_nfa) - float(ref.log_nfa)) \
        < 0.01 * abs(float(ref.log_nfa))


def test_refine_and_refit_parity():
    """The (R, t) polish (torch.func.jacfwd) and the IRLS refit from the
    same start: R and t within 5e-4 rad (eight float32 Gauss-Newton steps
    on each side; each lands ~1e-4 from the other's optimum), E to 1e-4
    after a sign fix."""
    sc = two_view_scene(n_points=200, noise=0.3, seed=8)
    R0 = make_relative_motion(0.102, -0.048, 0.031)[0]
    t0 = sc["t"] + np.array([0.01, -0.02, 0.0])
    w = np.ones(200)
    Rt, tt = test_.refine_relative_pose(T(R0), T(t0), T(sc["un"]),
                                        T(sc["vn"]), T(w))
    Rj, tj = jest.refine_relative_pose(J(R0), J(t0), J(sc["un"]),
                                       J(sc["vn"]), J(w))
    assert rotation_distance(Rt.numpy().astype(float),
                             np.asarray(Rj, float)) < 5e-4
    assert translation_angle(tt.numpy().astype(float),
                             np.asarray(tj, float)) < 5e-4
    mask = np.ones(200, bool)
    Et = test_._refit_essential(T(sc["un"]), T(sc["vn"]),
                                torch.from_numpy(mask),
                                torch.from_numpy(mask), 2.0 / 800)
    Ej = jest._refit_essential(J(sc["un"]), J(sc["vn"]), jnp.asarray(mask),
                               jnp.asarray(mask), 2.0 / 800)
    sgn = np.sign((Et.numpy() * np.asarray(Ej)).sum())
    np.testing.assert_allclose(Et.numpy() * sgn, np.asarray(Ej), atol=1e-4)
    np.testing.assert_allclose(test_._cross_mat(T(t0)).numpy(),
                               np.asarray(jest._cross_mat(J(t0))), atol=0)


# ---------------------------------------------------------------------------
# estimators, with the port's own generator: outcomes
# ---------------------------------------------------------------------------

def test_outcomes_with_the_port_generator():
    """The reference's RANSAC tests' gates, on the port's own draws."""
    g = torch.Generator().manual_seed(0)
    u, v, true_inl = plane_pair()
    res = test_.estimate_homography(g, T(u), T(v), torch.ones(100, dtype=bool),
                                    threshold=2.0, num_samples=500)
    inl = res.inliers.numpy()
    assert bool(res.success) and (inl & ~true_inl).sum() == 0
    assert inl.sum() >= 0.9 * true_inl.sum()

    sc = two_view_scene(n_points=150, noise=0.0, n_outliers=40, seed=5)
    res = test_.estimate_fundamental(g, T(sc["un"]), T(sc["vn"]),
                                     torch.ones(150, dtype=bool),
                                     threshold=2.0 / 800.0, num_samples=500)
    true_inl = np.ones(150, bool)
    true_inl[sc["outliers"]] = False
    inl = res.inliers.numpy()
    assert bool(res.success) and (inl & ~true_inl).sum() <= 2
    assert inl.sum() >= 0.9 * true_inl.sum()

    sc = two_view_scene(n_points=200, noise=0.2, n_outliers=50, seed=7)
    Kt = T(sc["K"])
    res, R, t = test_.estimate_relative_pose(
        g, T(sc["u"]), T(sc["v"]), torch.ones(200, dtype=bool), Kt, Kt,
        threshold_px=4.0, num_samples=300, min_inliers=100)
    assert bool(res.success)
    assert rotation_distance(R.numpy().astype(float), sc["R"]) < 0.01
    assert translation_angle(t.numpy().astype(float), sc["t"]) < 0.02

    X, rays, uv, K, R_gt, t_gt = pnp_scene()
    res, R, t = test_.estimate_absolute_pose(
        g, T(X), T(rays), T(uv), T(K), torch.ones(120, dtype=bool),
        threshold_px=5.0, num_samples=500, min_inliers=50)
    assert bool(res.success)
    assert rotation_distance(R.numpy().astype(float), R_gt) < 0.01
    assert np.linalg.norm(t.numpy() - t_gt) < 0.05


def test_precision_pins_hold_inside_the_estimators(monkeypatch):
    """Float32 products run in full float32 inside the estimators (TF32
    off for matmul and cuDNN), and the 5-point solver works in float64."""
    seen = []
    solver = test_.five_point_essential

    def recording(u, v, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        E, valid = solver(u, v, **kw)
        assert E.dtype == u.dtype == torch.float32
        return E, valid

    monkeypatch.setattr(test_, "five_point_essential", recording)
    sc = two_view_scene(n_points=60, noise=0.2, seed=1)
    Kt = T(sc["K"])
    test_.estimate_relative_pose(torch.Generator().manual_seed(0), T(sc["u"]),
                                 T(sc["v"]), torch.ones(60, dtype=bool), Kt,
                                 Kt, num_samples=20, min_inliers=10)
    assert seen == [(False, False, "highest")]


# ---------------------------------------------------------------------------
# The slice end to end: frontend -> matcher -> estimate_homography
# ---------------------------------------------------------------------------

SHIFT = 6


@pytest.fixture(scope="module")
def frames():
    from render3d import make_room

    tex = make_room(seed=0, tex_size=256)[1].tex[:96, :128 + SHIFT]
    tex = tex.astype(np.float32)
    return tex[:, SHIFT:], tex[:, :128]      # A(x) = B(x + SHIFT)


def test_slice_end_to_end(frames, monkeypatch):
    """Two 96x128 frames through each package's frontend, matcher and
    estimate_homography (the reference's draws injected): both H move the
    frame corners by the known shift within 0.5 px and agree within
    0.5 px; the inlier sets, compared as keypoint-position pairs, overlap
    by at least 90%."""
    from sara_tpu.features import api as japi
    from sara_tpu.features.dog import DoGParams as JaxDoGParams
    from sara_tpu.image.pyramid import PyramidParams
    from sara_tpu.matching import brute_force as jbf
    from sara_tpu_torch.convert import params_from_jax
    from sara_tpu_torch.features import api as tapi
    from sara_tpu_torch.matching import brute_force as tbf

    a, b = frames
    jp = japi.SIFTParams(pyramid=PyramidParams(first_octave=-1),
                         dog=JaxDoGParams(capacity=256, refine_iters=2),
                         total_capacity=512, desc_sample_nearest=False)
    ka, kb = (japi.compute_sift_keypoints(jnp.asarray(f), jp) for f in (a, b))
    mj = jbf.match_descriptors(ka, kb, jbf.MatchParams(ratio=0.8))
    uj, vj = ka.xy, kb.xy[mj.j]
    key = jax.random.PRNGKey(0)
    ref = jest.estimate_homography(key, uj, vj, mj.mask, threshold=4.0,
                                   num_samples=1000)

    tp = dataclasses.replace(params_from_jax(jp), desc_sampler="kernel")
    ta, tb = (tapi.compute_sift_keypoints(f, tp, device="cpu")
              for f in (a, b))
    mt = tbf.match_descriptors(ta, tb, params_from_jax(
        jbf.MatchParams(ratio=0.8)), device="cpu")
    ut, vt = ta.xy, tb.xy[mt.j.long()]
    inject(monkeypatch, key, 1000, 4, np.asarray(mj.mask))
    # The reference's indices address the reference's match slots; the
    # port's slots hold the same keypoints in the same order where the two
    # keypoint sets pair up, which they do for ~all rows (tested in
    # tests/test_torch_sift.py), so valid port rows stand in.
    out = test_.estimate_homography(torch.Generator(), ut, vt, mt.mask,
                                    threshold=4.0, num_samples=1000)
    assert bool(out.success) and bool(ref.success)
    assert int(mt.mask.sum()) >= 50
    shift = np.array([SHIFT, 0.0])
    box = (128.0, 96.0)
    c0 = corners_moved(np.eye(3), *box)
    for H in (out.model.numpy(), np.asarray(ref.model)):
        assert np.abs(corners_moved(H, *box) - c0 - shift).max() < 0.5
    assert np.abs(corners_moved(out.model.numpy(), *box)
                  - corners_moved(np.asarray(ref.model), *box)).max() < 0.5

    def pairs(u, v, inl):
        u, v, inl = np.asarray(u), np.asarray(v), np.asarray(inl)
        return {tuple(np.round(np.r_[p, q], 1)) for p, q in
                zip(u[inl], v[inl])}

    pt = pairs(ut.numpy(), vt.numpy(), out.inliers.numpy())
    pj = pairs(uj, vj, ref.inliers)
    assert len(pt & pj) >= 0.9 * max(len(pt), len(pj))
