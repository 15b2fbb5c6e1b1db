"""The port's Kalman filter and multi-object tracker
(``sara_tpu_torch/tracking``) against their twin ``sara_tpu/tracking`` on
the CPU. The twin's model is float64 here (``jnp.eye`` under the suite's
x64); the port's is float32, so states are held to 1e-4 relative and
boxes to 1e-3 px."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.tracking import kalman as jkf
from sara_tpu.tracking import mot as jmot
from sara_tpu_torch.tracking import kalman as tkf
from sara_tpu_torch.tracking import mot as tmot
from sara_tpu_torch.tracking import (
    GaussianState, MultiObjectTracker, constant_velocity_box_model,
    iou_matrix, kf_predict, kf_update)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _states(rs, B):
    x = rs.normal(scale=5.0, size=(B, 8))
    L = rs.normal(size=(B, 8, 8))
    P = L @ L.transpose(0, 2, 1) + 0.5 * np.eye(8)
    return x.astype(np.float32), P.astype(np.float32)


def test_kf_predict_update_mahalanobis_match_twin():
    rs = np.random.RandomState(0)
    x, P = _states(rs, 5)
    z = rs.normal(scale=5.0, size=(5, 4)).astype(np.float32)
    jm = jkf.constant_velocity_box_model(dt=0.5, q=0.3, r=2.0)
    tm = constant_velocity_box_model(dt=0.5, q=0.3, r=2.0, device="cpu")
    for a, b in zip(jm, tm):
        assert b.dtype == torch.float32
        _close(b.numpy(), a)

    js = jkf.kf_predict(jkf.GaussianState(jnp.asarray(x), jnp.asarray(P)), jm)
    ts = kf_predict(GaussianState(torch.from_numpy(x), torch.from_numpy(P)),
                    tm)
    _close(ts.x.numpy(), js.x)
    _close(ts.P.numpy(), js.P)

    (jp, jy, jS) = jkf.kf_update(js, jm, jnp.asarray(z))
    (tp, ty, tS) = kf_update(ts, tm, torch.from_numpy(z))
    for a, b in ((jp.x, tp.x), (jp.P, tp.P), (jy, ty), (jS, tS)):
        _close(b.numpy(), a)
    _close(tkf.mahalanobis2(ty, tS).numpy(), jkf.mahalanobis2(jy, jS))


def test_iou_and_cosine_match_twin():
    rs = np.random.RandomState(1)
    a = np.concatenate([rs.uniform(0, 50, (7, 2)), rs.uniform(2, 20, (7, 2))],
                       1)
    b = np.concatenate([rs.uniform(0, 50, (9, 2)), rs.uniform(2, 20, (9, 2))],
                       1)
    np.testing.assert_allclose(iou_matrix(a, b), jmot.iou_matrix(a, b),
                               atol=1e-6)
    fa, fb = rs.normal(size=(7, 16)), rs.normal(size=(9, 16))
    np.testing.assert_allclose(tmot.cosine_distance(fa, fb),
                               jmot.cosine_distance(fa, fb), atol=1e-12)


def _stream(n_frames=50, seed=0, dim=16):
    """Seeded detections: 6 objects at constant velocity in their own
    lanes (never overlapping), 1 px noise, 10% dropped, two entering late
    and one leaving early; plus each object's noisy appearance vector."""
    rs = np.random.RandomState(seed)
    n_obj = 6
    start = np.array([0, 0, 0, 0, 12, 20])
    end = np.array([50, 50, 30, 50, 50, 50])
    p0 = np.stack([rs.uniform(20, 60, n_obj), 30.0 + 40.0 * np.arange(n_obj)],
                  1)
    v = np.stack([rs.uniform(0.5, 2.0, n_obj), rs.uniform(-0.2, 0.2, n_obj)],
                 1)
    size = np.stack([rs.uniform(16, 24, n_obj), rs.uniform(12, 18, n_obj)], 1)
    feat = rs.normal(size=(n_obj, dim))
    frames = []
    for k in range(n_frames):
        live = [o for o in range(n_obj) if start[o] <= k < end[o]
                and rs.rand() > 0.1]
        boxes = np.array([np.concatenate([p0[o] + v[o] * k, size[o]])
                          + rs.normal(scale=1.0, size=4) for o in live]
                         ).reshape(-1, 4).astype(np.float32)
        feats = np.array([feat[o] + rs.normal(scale=0.05, size=dim)
                          for o in live]).reshape(-1, dim)
        order = rs.permutation(len(live))
        frames.append((boxes[order], feats[order]))
    return frames


@pytest.mark.parametrize("appearance_weight", [0.0, 0.3])
def test_tracker_stream_matches_twin(appearance_weight):
    """A 50-frame stream through both trackers: the same confirmed IDs in
    the same order every frame, boxes within 1e-3 px; at most two device
    reads per step."""
    jt = jmot.MultiObjectTracker(min_hits=2, max_misses=3,
                                 appearance_weight=appearance_weight)
    tt = MultiObjectTracker(min_hits=2, max_misses=3,
                            appearance_weight=appearance_weight,
                            device="cpu")
    feats_on = appearance_weight > 0
    n_out = 0
    for k, (boxes, feats) in enumerate(_stream()):
        f = feats if feats_on else None
        jo = jt.step(boxes, f)
        before = tt.syncs
        to = tt.step(boxes, f)
        assert tt.syncs - before <= 2
        assert [i for i, _ in to] == [i for i, _ in jo], k
        for (_, a), (_, b) in zip(jo, to):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-3)
        n_out += len(to)
        assert [t.track_id for t in tt.tracks] == [t.track_id
                                                   for t in jt.tracks]
        for t, u in zip(tt.tracks, jt.tracks):
            assert (t.hits, t.misses, t.age) == (u.hits, u.misses, u.age)
            np.testing.assert_allclose(t.state.x.numpy(),
                                       np.asarray(u.state.x), atol=1e-3)
    assert n_out > 150


def test_kf_converges_to_constant_velocity():
    """Twin of ``test_tracking_geometry.py::test_kf_converges_to_constant_
    velocity``."""
    model = constant_velocity_box_model(dt=1.0, q=1e-4, r=0.01, device="cpu")
    state = GaussianState(torch.zeros(8), torch.eye(8) * 10.0)
    rs = np.random.RandomState(0)
    for k in range(30):
        z = (np.array([k * 2.0, k * 1.0, 10.0, 20.0])
             + rs.normal(scale=0.05, size=4))
        state = kf_predict(state, model)
        state, _, _ = kf_update(state, model,
                                torch.tensor(z, dtype=torch.float32))
    x = state.x.numpy()
    np.testing.assert_allclose(x[4], 2.0, atol=0.1)   # vx
    np.testing.assert_allclose(x[5], 1.0, atol=0.1)   # vy


def test_iou_matrix():
    """Twin of ``test_tracking_geometry.py::test_iou_matrix``."""
    a = np.array([[0.0, 0, 2, 2]])
    b = np.array([[0.0, 0, 2, 2], [1, 1, 2, 2], [10, 10, 2, 2]])
    m = iou_matrix(a, b)
    np.testing.assert_allclose(m[0, 0], 1.0)
    np.testing.assert_allclose(m[0, 1], 1.0 / 7.0, atol=1e-6)
    assert m[0, 2] == 0


def test_mot_tracks_two_objects():
    """Twin of ``test_tracking_geometry.py::test_mot_tracks_two_objects``."""
    mot = MultiObjectTracker(min_hits=2, max_misses=3, device="cpu")
    ids_seen = {}
    for k in range(12):
        dets = np.array([[10.0 + 2 * k, 10.0, 4, 4],
                         [50.0, 30.0 + k, 5, 5]])
        for tid, box in mot.step(dets):
            ids_seen.setdefault(tid, []).append(box)
    assert len(ids_seen) == 2
    lens = sorted(len(v) for v in ids_seen.values())
    assert lens[0] >= 8
    fast = max(ids_seen.values(), key=lambda v: v[-1][0])
    assert fast[-1][0] > 25


def test_mot_handles_misses():
    """Twin of ``test_tracking_geometry.py::test_mot_handles_misses``."""
    mot = MultiObjectTracker(min_hits=2, max_misses=4, device="cpu")
    for k in range(6):
        mot.step(np.array([[10.0 + k, 10.0, 4, 4]]))
    out_before = mot.step(np.array([[16.0, 10, 4, 4]]))
    tid_before = out_before[0][0]
    mot.step(np.zeros((0, 4)))
    mot.step(np.zeros((0, 4)))
    out_after = mot.step(np.array([[19.0, 10.0, 4, 4]]))
    assert out_after and out_after[0][0] == tid_before
