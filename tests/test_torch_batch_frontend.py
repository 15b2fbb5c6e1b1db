"""Port parity: the batched frontend (``features/api.py::_compute_sift_batch``
and ``sfm/odometry.py::_fused_frontend_batch``).

Three frames of ``tests/render3d.py::make_room(seed=1)`` at 96x128 (the
room loop's poses, ``chip_smoke.vo_frames``), capacities 256 / 512, the
"gather" sampler (the path that runs on the CPU):

- batched against per-frame in the port: every field of frame b of
  ``_compute_sift_batch`` equals ``compute_sift_keypoints`` of frame b
  within 1e-5 (masks exactly). The CPU convolves each plane alone in the
  frontend (``image/filtering.py::planewise``), so in fact they are equal
  bit for bit;
- against the JAX package: ``jax.vmap(_compute_sift_jit)`` on the same
  float32 stack, by the end-to-end rule of ``tests/test_torch_sift.py``
  (each JAX keypoint paired with a port keypoint within 0.5 px and 1e-2 rad
  for >= 95% of them in each frame; paired descriptors within 1e-4 for
  >= 95% of the window's pairs, all within 1e-2);
- the fused window against the reference's ``_fused_frontend_batch`` on the
  same frames and ``prev_kp``: with the reference's detections and RANSAC
  samples handed to the port, equal match sets, successes, inlier masks,
  rotations within 0.1 degree and translation directions within 0.1 degree;
  with the port's own detections and draws, the outcome (successes equal,
  inlier counts within 5% + 2, match sets sharing >= 95% of their
  position pairs within 0.5 px, rotations within 2 degrees of each other).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.features import api as japi
from sara_tpu.features.dog import DoGParams as JaxDoGParams
from sara_tpu.image.pyramid import PyramidParams
from sara_tpu.ransac import engine as jengine
from sara_tpu.sfm import odometry as jodo
from sara_tpu_torch.convert import keypoints_from_numpy, params_from_jax
from sara_tpu_torch.core.types import Keypoints, Matches
from sara_tpu_torch.features import api as tapi
from sara_tpu_torch.features.sift import sift_descriptors_field
from sara_tpu_torch.ops import patch_sampler as ps
from sara_tpu_torch.ransac import engine as tengine
from sara_tpu_torch.sfm import odometry as todo

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chip_smoke import vo_frames  # noqa: E402

HW = (96, 128)
BATCH_TOL = 1e-5          # batched against per-frame, every float field
RANSAC_SAMPLES = 300
MIN_INLIERS = 15


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(config: str):
    """capacities 256 / 512; "slice" = the -1 octave with bilinear field
    descriptors, "vo" = the odometry's first octave 0, "nearest" = nearest
    field descriptors and "grid" = the exact-grid descriptor, both at
    octave 0 (for time; the octave is not what they vary)."""
    return japi.SIFTParams(
        pyramid=PyramidParams(first_octave=-1 if config == "slice" else 0),
        dog=JaxDoGParams(capacity=256, refine_iters=2), total_capacity=512,
        desc_sample_nearest=config == "nearest",
        descriptor_field=config != "grid")


@pytest.fixture(scope="module")
def room():
    """(K, four frames): frame 0 is the window's ``prev_kp`` source, frames
    1-3 the window."""
    K, imgs, _ = vo_frames(4, hw=HW)
    return K, np.stack(imgs).astype(np.float32)


@pytest.fixture(scope="module")
def batched(room):
    """The port's batched detection of frames 1-3, by configuration, each
    computed once."""
    cache = {}

    def get(config):
        if config not in cache:
            cache[config] = tapi._compute_sift_batch(
                room[1][1:], params_from_jax(_jax_params(config)),
                device="cpu")
        return cache[config]
    return get


@pytest.mark.parametrize("config", ["slice", "nearest", "vo", "grid"])
def test_batch_equals_per_frame(room, batched, config):
    """Frame b of one batched pass equals the frame alone, field by field
    (within ``BATCH_TOL``; masks exactly)."""
    tp = params_from_jax(_jax_params(config))
    stack = room[1][1:]
    kb = batched(config)
    assert kb.xy.shape == (3, 512, 2) and kb.descriptors.shape == (3, 512,
                                                                   128)
    for b in range(3):
        one = tapi.compute_sift_keypoints(stack[b], tp, device="cpu")
        assert torch.equal(kb.mask[b], one.mask)
        assert int(one.count()) > 10
        for name in ("xy", "scale", "orientation", "response",
                     "descriptors"):
            err = (getattr(kb, name)[b] - getattr(one, name)).abs().max()
            assert float(err) <= BATCH_TOL, name


def test_batch_rejects_a_single_image(room):
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        tapi._compute_sift_batch(room[1][0], params_from_jax(
            _jax_params("slice")), device="cpu")


def _pair(xj, oj, xt, ot):
    """Pair each JAX keypoint with the port keypoint nearest in position +
    orientation: (paired mask, port row of each)."""
    dpos = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    dang = np.abs(np.angle(np.exp(1j * (oj[:, None] - ot[None]))))
    nn = (dpos + dang).argmin(axis=1)
    rows = np.arange(len(nn))
    return (dpos[rows, nn] < 0.5) & (dang[rows, nn] < 1e-2), nn


def test_batch_matches_jax_vmap(room, batched, windows):
    """``_compute_sift_batch`` against ``jax.vmap(_compute_sift_jit)`` on
    the same float32 stack by the overlap rule: per frame, counts within
    5% + 1 and >= 95% of the JAX keypoints paired; over the window, >= 95%
    of the paired descriptors within 1e-4 and all within 1e-2 (Newton's
    amplification of the pyramids' ulps moves a few poorly conditioned
    keypoints' descriptors by up to ~1e-3, ``tests/test_torch_sift.py``).
    The JAX detection is the reference window's own ``jax.vmap(detect)``
    of the same frames ("slice"; the reference's window has no
    undistortion, so ``detect`` is ``_compute_sift_jit``)."""
    kj = windows["ref"][0]
    kt = batched("slice")
    errs = []
    for b in range(3):
        mj, mt = np.asarray(kj.mask[b]), kt.mask[b].numpy()
        nj, nt = int(mj.sum()), int(mt.sum())
        assert nj > 10 and abs(nj - nt) <= 0.05 * nj + 1
        paired, nn = _pair(np.asarray(kj.xy[b])[mj],
                           np.asarray(kj.orientation[b])[mj],
                           kt.xy[b].numpy()[mt], kt.orientation[b].numpy()[mt])
        assert paired.mean() >= 0.95
        dj = np.asarray(kj.descriptors[b])[mj][paired]
        dt = kt.descriptors[b].numpy()[mt][nn[paired]]
        errs.append(np.abs(dj - dt).max(axis=1))
    errs = np.concatenate(errs)
    assert (errs <= 1e-4).mean() >= 0.95 and errs.max() <= 1e-2


@pytest.fixture(scope="module")
def windows(room):
    """The reference's fused window (frames 1-3 against frame 0's JAX
    detection, keys split from PRNGKey(3)), and its inputs."""
    K, frames = room
    jp = _jax_params("slice")
    prev = japi.compute_sift_keypoints(jnp.asarray(frames[0]), jp)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = jodo._fused_frontend_batch(
        jnp.asarray(frames[1:]), jnp.zeros((1, 1)), jnp.zeros((1, 1)), prev,
        keys, jnp.asarray(K), jp, 0.8, 4.0, RANSAC_SAMPLES, MIN_INLIERS,
        False)
    return dict(K=K, frames=frames, jp=jp, prev=prev, keys=keys, ref=ref)


def _port_window(w):
    return todo._fused_frontend_batch(
        torch.as_tensor(w["frames"][1:]), None, None,
        keypoints_from_numpy(w["prev"], device="cpu"),
        torch.Generator().manual_seed(0),
        torch.as_tensor(w["K"], dtype=torch.float32), params_from_jax(w["jp"]),
        0.8, 4.0, RANSAC_SAMPLES, MIN_INLIERS, False)


def _rot_deg(A, B) -> float:
    c = (np.trace(np.asarray(A, float) @ np.asarray(B, float).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def _dir_deg(a, b) -> float:
    a, b = np.asarray(a, float).ravel(), np.asarray(b, float).ravel()
    c = abs(a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
    return float(np.degrees(np.arccos(min(c, 1.0))))


def test_fused_window_on_the_references_detections_and_samples(
        windows, monkeypatch):
    """The pair stage held tightly: the reference's window detections
    replace the port's (``_compute_sift_batch`` patched) and each pair's
    RANSAC samples are the reference's (``draw_samples`` patched, the
    pairs' draws stacked). Match sets, successes and inlier masks equal;
    R and t's direction within 0.1 degree."""
    ref_kp, ref_m, ref_res, ref_R, ref_t = windows["ref"]
    given = keypoints_from_numpy(ref_kp, device="cpu")
    monkeypatch.setattr(todo, "_compute_sift_batch", lambda *a, **k: given)
    drawn = [jengine.draw_samples(windows["keys"][b], RANSAC_SAMPLES, 5,
                                  ref_m.mask[b]) for b in range(3)]
    idx = torch.from_numpy(np.stack([np.asarray(d[0]) for d in drawn])
                           .astype(np.int64))
    ok = torch.from_numpy(np.stack([np.asarray(d[1]) for d in drawn]))
    monkeypatch.setattr(tengine, "draw_samples", lambda *a: (idx, ok))
    kp, m, res, R, t = _port_window(windows)
    assert torch.equal(m.mask, torch.from_numpy(np.asarray(ref_m.mask)))
    live = m.mask.numpy()
    np.testing.assert_array_equal(m.j.numpy()[live],
                                  np.asarray(ref_m.j)[live])
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(ref_res.success))
    assert res.success.all() and int(m.count().min()) > 50
    np.testing.assert_array_equal(res.inliers.numpy(),
                                  np.asarray(ref_res.inliers))
    for b in range(3):
        assert _rot_deg(R[b], ref_R[b]) <= 0.1
        assert _dir_deg(t[b], ref_t[b]) <= 0.1


def test_fused_window_outcome_on_its_own(windows):
    """The port's own window (its detections, one draw for the three
    pairs) against the reference's: the same successes, inlier counts
    within 5% + 2, match sets sharing >= 95% of their position pairs, and
    rotations within 2 degrees of each other."""
    ref_kp, ref_m, ref_res, ref_R, _ = windows["ref"]
    kp, m, res, R, t = _port_window(windows)
    assert kp.capacity == 512 and m.capacity == 512
    assert tuple(m.count().shape) == (3,) and tuple(kp.count().shape) == (3,)
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(ref_res.success))
    prev_xy = np.asarray(windows["prev"].xy)
    for b in range(3):
        nj, nt = int(ref_res.num_inliers[b]), int(res.num_inliers[b])
        assert abs(nj - nt) <= 0.05 * nj + 2
        lj = prev_xy if b == 0 else np.asarray(ref_kp.xy[b - 1])
        lt = prev_xy if b == 0 else kp.xy[b - 1].numpy()
        mj, mt = np.asarray(ref_m.mask[b]), m.mask[b].numpy()
        pj = np.concatenate([lj[np.asarray(ref_m.i[b])[mj]],
                             np.asarray(ref_kp.xy[b])[np.asarray(
                                 ref_m.j[b])[mj]]], axis=1)
        pt = np.concatenate([lt[m.i[b].numpy()[mt]],
                             kp.xy[b].numpy()[m.j[b].numpy()[mt]]], axis=1)
        near = np.abs(pj[:, None] - pt[None]).max(-1).min(1) < 0.5
        assert len(pj) > 50 and near.mean() >= 0.95
        assert _rot_deg(R[b], ref_R[b]) <= 2.0


def test_process_frames_runs_one_fused_window_per_window(room, monkeypatch):
    """``process_frames`` sends each window of ``frontend_batch`` frames
    through ``_fused_frontend_batch`` once, a short last window padded to
    B with its last frame (whose pair takes no E-RANSAC); no frame goes
    through the per-frame frontend."""
    K, frames = room
    calls, real = [], []
    fused = todo._fused_frontend_batch

    def counted(imgs, *args, **kwargs):
        calls.append(imgs.clone())
        real.append(kwargs["n_real"])
        return fused(imgs, *args, **kwargs)

    monkeypatch.setattr(todo, "_fused_frontend_batch", counted)
    monkeypatch.setattr(todo.OdometryPipeline, "_frontend", None)
    cfg = todo.OdometryConfig(
        sift=params_from_jax(_jax_params("vo")), rel_pose_samples=64,
        rel_pose_samples_fast=32, rel_pose_min_inliers=MIN_INLIERS,
        pnp_samples=64, pnp_min_inliers=8, frontend_batch=2)
    pipe = todo.OdometryPipeline(K, cfg, device="cpu")
    out = pipe.process_frames(list(frames), list(range(4)))
    assert len(out) == 4
    assert [tuple(c.shape) for c in calls] == [(2, 96, 128)] * 2
    assert torch.equal(calls[1][0], calls[1][1])        # frame 3 repeated
    assert real == [2, 1]          # the padded pair takes no E-RANSAC
    assert torch.equal(calls[0][0], torch.from_numpy(frames[1]))


def test_batched_keypoints_capacity_and_count():
    """``capacity`` reads the slot axis; ``count()`` counts per set."""
    kp = Keypoints.empty(16, device="cpu")
    kb = Keypoints(*(torch.stack([f, f, f]) for f in kp))
    mask = torch.zeros(3, 16, dtype=torch.bool)
    mask[0, :5] = True
    mask[2, 3:4] = True
    kb = kb._replace(mask=mask)
    assert kp.capacity == kb.capacity == 16
    assert int(kp.count()) == 0 and kp.count().dim() == 0
    assert kb.count().tolist() == [5, 0, 1]
    m = Matches.empty(8, device="cpu")
    mb = Matches(*(torch.stack([f, f]) for f in m))
    mb = mb._replace(mask=torch.tensor([[True] * 3 + [False] * 5,
                                        [True] * 8]))
    assert m.capacity == mb.capacity == 8
    assert mb.count().tolist() == [3, 8]


def test_folded_field_equals_per_frame_sampling():
    """K1's wrapper on the frame-folded (B·S, H, W, C) field with
    ``s_idx + b·S`` equals per-frame plain sampling, and the descriptors
    of a batch through the "kernel" sampler (the plain version here) equal
    each frame's."""
    rs = np.random.RandomState(0)
    B, S, H, W, K = 3, 4, 30, 40, 20
    maps = torch.from_numpy(rs.rand(B, S, H, W, 36).astype(np.float32))
    s_idx = torch.from_numpy(rs.randint(0, S, (B, K)))
    ys = torch.from_numpy(rs.uniform(-2, H + 1, (B, K, 16))
                          .astype(np.float32))
    xs = torch.from_numpy(rs.uniform(-2, W + 1, (B, K, 16))
                          .astype(np.float32))
    folded = ps.sample_field_patches(
        maps.reshape(B * S, H, W, 36),
        (s_idx + S * torch.arange(B)[:, None]).reshape(-1),
        ys.reshape(-1, 16), xs.reshape(-1, 16), max_sample_radius=10.0)
    for b in range(B):
        one = ps.sample_field_patches(maps[b], s_idx[b], ys[b], xs[b],
                                      max_sample_radius=10.0)
        assert torch.equal(folded[b * K:(b + 1) * K], one)
    x = torch.from_numpy(rs.uniform(0, W, (B, K)).astype(np.float32))
    y = torch.from_numpy(rs.uniform(0, H, (B, K)).astype(np.float32))
    s = torch.from_numpy(rs.uniform(0, S - 1, (B, K)).astype(np.float32))
    th = torch.from_numpy(rs.uniform(-3, 3, (B, K)).astype(np.float32))
    sig = (1.6, 2.0, 2.5, 3.2)
    db = sift_descriptors_field(maps, x, y, s, th, sig, sampler="kernel")
    assert db.shape == (B, K, 128)
    for b in range(B):
        one = sift_descriptors_field(maps[b], x[b], y[b], s[b], th[b], sig,
                                     sampler="kernel")
        assert float((db[b] - one).abs().max()) <= BATCH_TOL


@pytest.mark.parametrize("what", ["pixels", "samples"])
def test_card_side_refuses_a_folded_field_past_2_31(what):
    """The card's side of the wrapper raises where the folded field's
    B·S·H·W pixels or K·N samples reach 2^31 (the kernels index in 32
    bits), before it builds or launches anything; meta tensors stand in
    for the sizes. Eight 480x640 frames at octave -1 (5 slices of 960 x
    1280 each) pass the check."""
    ps.check_launch_size((8 * 5, 960, 1280, 36), 8 * 5120, 16)
    if what == "pixels":
        maps = torch.empty((2 ** 31 // (960 * 1280) + 1, 960, 1280, 36),
                           device="meta")
        ys = torch.empty((64, 16), device="meta")
    else:
        maps = torch.empty((40, 96, 128, 36), device="meta")
        ys = torch.empty((2 ** 27, 16), device="meta")
    s_idx = torch.zeros(ys.shape[0], dtype=torch.int32, device="meta")
    before = ps.counts()
    with pytest.raises(ValueError, match=r"2\^31"):
        ps._sample_on_card(maps, s_idx, ys, ys, False)
    assert ps.counts() == before
