"""The port's matching extras (``sara_tpu_torch/matching/{propagation,ncc,
key_proximity}.py``) against their twins on the CPU: the consistency
matrix and the propagated regions equal on a seeded affine scene with
planted outliers fed identically to both, NCC matches (with the gain /
bias case) and self-matching equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core import types as jtypes
from sara_tpu.matching import ncc as jncc
from sara_tpu.matching import propagation as jprop
from sara_tpu.matching.key_proximity import self_match as jself_match
from sara_tpu_torch.core import types as ttypes
from sara_tpu_torch.matching import (PropagationParams,
                                     match_consistency_matrix,
                                     propagate_matches)
from sara_tpu_torch.matching.key_proximity import self_match
from sara_tpu_torch.matching.ncc import ncc_match


def _scene(n_in=60, n_out=20, cap=128, seed=0, theta=0.3, s=1.2,
           jitter=0.0, ties=False):
    """The twin test's scene (``test_match_propagation.py::_make_scene``):
    a similarity-warped keypoint set with planted outlier matches, as
    float32 arrays; ``jitter`` adds per-keypoint noise to the positions,
    scales and orientations. Scores are distinct, or with ``ties`` drawn
    from four values (seeds are then taken in index order among equal
    scores, as the twin's ``lax.top_k`` takes them)."""
    rs = np.random.RandomState(seed)
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    t = np.array([30.0, -12.0])
    xa = rs.uniform(0, 150, size=(n_in, 2))
    xb = (s * xa @ R.T) + t
    xa_out = rs.uniform(0, 150, size=(n_out, 2))
    xb_out = rs.uniform(0, 150, size=(n_out, 2))
    n = n_in + n_out

    def kps(xy, extra_xy, rot, scale):
        pos = np.concatenate([xy, extra_xy], 0)
        pos = pos + jitter * rs.normal(size=pos.shape)
        f = np.zeros((cap,), np.float32)
        return dict(
            xy=np.pad(pos, ((0, cap - n), (0, 0))).astype(np.float32),
            scale=(5.0 * scale * (1 + 0.1 * jitter * rs.normal(size=cap))
                   ).astype(np.float32),
            orientation=(rot + 0.1 * jitter * rs.normal(size=cap)
                         ).astype(np.float32),
            response=f, descriptors=np.zeros((cap, 4), np.float32),
            mask=np.arange(cap) < n)

    ka, kb = kps(xa, xa_out, 0.0, 1.0), kps(xb, xb_out, theta, s)
    idx = np.pad(np.arange(n), (0, cap - n)).astype(np.int32)
    score = rs.permutation(n) / n * 0.4 + 0.1
    if ties:
        score = rs.choice([0.0, 0.1, 0.2, 0.3], n)
    m = dict(i=idx, j=idx.copy(),
             score=np.pad(score, (0, cap - n)).astype(np.float32),
             mask=np.arange(cap) < n)
    inlier = np.zeros(cap, bool)
    inlier[:n_in] = True
    outlier = np.zeros(cap, bool)
    outlier[n_in:n] = True
    return ka, kb, m, inlier, outlier


def _pkg(ka, kb, m):
    """The scene as each package's containers: (JAX, port)."""
    j = (jtypes.Keypoints(**{k: jnp.asarray(v) for k, v in ka.items()}),
         jtypes.Keypoints(**{k: jnp.asarray(v) for k, v in kb.items()}),
         jtypes.Matches(**{k: jnp.asarray(v) for k, v in m.items()}))
    t = (ttypes.Keypoints(**{k: torch.from_numpy(v) for k, v in ka.items()}),
         ttypes.Keypoints(**{k: torch.from_numpy(v) for k, v in kb.items()}),
         ttypes.Matches(**{k: torch.from_numpy(v) for k, v in m.items()}))
    return j, t


SCENES = {"similarity": dict(), "jittered": dict(jitter=0.8, seed=3),
          "no_rotation": dict(theta=0.0, s=1.0, seed=5),
          "tied_scores": dict(seed=7, ties=True)}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_consistency_matrix_equal(scene):
    ka, kb, m, _, _ = _scene(**SCENES[scene])
    (ja, jb, jm), (ta, tb, tm) = _pkg(ka, kb, m)
    params = jprop.PropagationParams(neighborhood_radius=12.0)
    want = np.asarray(jprop.match_consistency_matrix(ja, jb, jm, params))
    got = match_consistency_matrix(ta, tb, tm,
                                   PropagationParams(neighborhood_radius=12.0))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("num_seeds", [8, 16])
def test_propagate_matches_equal(scene, num_seeds):
    """Members, labels and the densified mask equal the twin's."""
    ka, kb, m, _, _ = _scene(**SCENES[scene])
    (ja, jb, jm), (ta, tb, tm) = _pkg(ka, kb, m)
    jout = jprop.propagate_matches(ja, jb, jm, num_seeds=num_seeds)
    tout = propagate_matches(ta, tb, tm, num_seeds=num_seeds)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tout[1].dtype == torch.int32 and tout[2].sum() > 20


def test_propagation_keeps_inliers_rejects_outliers():
    """Twin of ``test_match_propagation.py::test_propagation_keeps_inliers_
    rejects_outliers``."""
    ka, kb, m, inlier, outlier = _scene()
    _, (ta, tb, tm) = _pkg(ka, kb, m)
    params = PropagationParams(neighborhood_radius=12.0, min_votes=3)
    members, labels, densified = propagate_matches(ta, tb, tm, num_seeds=16,
                                                   params=params)
    densified = densified.numpy()
    assert densified[inlier].mean() >= 0.8
    assert densified[outlier].sum() <= 2
    labels = labels.numpy()
    assert (labels[densified] >= 0).all()
    assert (labels[~densified] == -1).all()


def test_propagation_no_valid_matches():
    """Twin of ``test_match_propagation.py::test_propagation_no_valid_
    matches``."""
    ka, kb, m, _, _ = _scene()
    m["mask"] = np.zeros_like(m["mask"])
    _, (ta, tb, tm) = _pkg(ka, kb, m)
    _, _, densified = propagate_matches(ta, tb, tm, num_seeds=8)
    assert not bool(densified.any())


def _ncc_both(img_a, xy_a, mask_a, img_b, xy_b, mask_b, **kw):
    j = jncc.ncc_match(jnp.asarray(img_a), jnp.asarray(xy_a),
                       jnp.asarray(mask_a), jnp.asarray(img_b),
                       jnp.asarray(xy_b), jnp.asarray(mask_b), **kw)
    t = ncc_match(img_a, xy_a, mask_a, img_b, xy_b, mask_b, device="cpu",
                  **kw)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("case", ["shift", "gain_bias", "masked_border"])
def test_ncc_match_matches_twin(case):
    """The same matches, scores within 1e-5; the twin tests' cases (a 5-px
    shift, a gain/bias copy) among 60 seeded keypoints, and masked or
    border keypoints."""
    rs = np.random.RandomState(1)
    a = rs.random((64, 96)).astype(np.float32)
    xy_a = np.stack([rs.uniform(0, 96, 60), rs.uniform(0, 64, 60)],
                    1).astype(np.float32)
    mask_a = np.ones(60, bool)
    mask_b = np.ones(60, bool)
    if case == "shift":
        b = np.roll(a, 5, axis=1)
        xy_b = xy_a + np.float32([5.0, 0.0])
    elif case == "gain_bias":
        b = (0.5 * a + 0.25).astype(np.float32)
        xy_b = xy_a.copy()
    else:
        b = a.copy()
        xy_b = xy_a[rs.permutation(60)]
        mask_a[::7] = False
        mask_b[::5] = False
    (jj, js, jo), (tj, ts, to) = _ncc_both(a, xy_a, mask_a, b, xy_b, mask_b)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tj[to], jj[jo])
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_allclose(ts[fin], js[fin], atol=1e-5)
    assert to.sum() >= 20
    if case == "gain_bias":
        np.testing.assert_array_equal(tj[to], np.nonzero(to)[0])
        assert ts[to].min() > 0.99


def test_ncc_match_translated():
    """Twin of ``test_misc_modules.py::test_ncc_match_translated``."""
    rng = np.random.default_rng(42)
    img = rng.random((64, 96)).astype(np.float32)
    shifted = np.roll(img, 5, axis=1)
    xy_a = np.asarray([[20.0, 30], [50, 20], [70, 40]], np.float32)
    xy_b = xy_a + np.asarray([5.0, 0], np.float32)
    j, s, ok = ncc_match(img, xy_a, np.ones(3, bool), shifted, xy_b,
                         np.ones(3, bool), device="cpu")
    assert ok.all() and j.tolist() == [0, 1, 2] and float(s.min()) > 0.99


@pytest.mark.parametrize("seed", [0, 1])
def test_self_match_matches_twin(seed):
    """Twin of ``test_extra_solvers.py::test_self_match_repeated_structure``
    on 48 keypoints with planted repeats: the same accepted matches."""
    rs = np.random.default_rng(seed)
    cap = 48
    d = rs.normal(size=(cap, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xy = rs.uniform(0, 500, (cap, 2)).astype(np.float32)
    for a, b, off in ((0, 1, 200.0), (2, 3, 150.0), (4, 5, 3.0)):
        d[b] = d[a] + 0.01 * rs.normal(size=128).astype(np.float32)
        xy[b] = xy[a] + off
    scale = rs.uniform(1, 4, cap).astype(np.float32)
    mask = np.ones(cap, bool)
    mask[-3:] = False
    fields = dict(xy=xy, scale=scale, orientation=np.zeros(cap, np.float32),
                  response=np.ones(cap, np.float32), descriptors=d, mask=mask)
    jm = jself_match(jtypes.Keypoints(**{k: jnp.asarray(v)
                                         for k, v in fields.items()}))
    tm = self_match(ttypes.Keypoints(**{k: torch.from_numpy(v)
                                        for k, v in fields.items()}))
    ok = np.asarray(jm.mask)
    np.testing.assert_array_equal(tm.mask.numpy(), ok)
    np.testing.assert_array_equal(tm.j.numpy()[ok], np.asarray(jm.j)[ok])
    np.testing.assert_allclose(tm.score.numpy()[ok], np.asarray(jm.score)[ok],
                               atol=1e-5)
    got = tm.j.numpy()
    assert ok[0] and got[0] == 1 and ok[1] and got[1] == 0
    assert ok[2] and got[2] == 3
    assert not (ok[4] and got[4] == 5)      # 3 px apart: excluded
