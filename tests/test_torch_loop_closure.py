"""Port parity: loop closure (``sfm/loop_closure.py``) against its
``sara_tpu`` twin.

Retrieval is held bit for bit where both sides compute on the host in
NumPy (``kmeans_codebook``, ``global_descriptor``, ``vlad_signature``), and
to 1e-5 where both compute on their device in float32 (``_vlad_device``).
The closer draws its RANSAC samples from its own generator (seeded 42), so
the loop itself is held by outcome to the reference test's gates
(tests/test_loop_closure.py, which the reference marks slow; the port's
run takes well under a minute on the CPU).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu.core.types import Keypoints as JKeypoints
from sara_tpu.sfm import loop_closure as JL
from sara_tpu_torch.convert import keypoints_from_numpy, params_from_jax
from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
from sara_tpu_torch.sfm import loop_closure as TL
from sara_tpu_torch.utils import ate_rmse

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_loop_closure import _make_loop_sequence  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the machine's cores, and torch's default of a thread per core makes
    the port's many small operations wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keypoint_pair(seed, n=300, valid=220):
    """The same keypoint set as a JAX and a port (CPU) Keypoints: unit
    float32 descriptors, a validity mask with ``valid`` rows."""
    rs = np.random.RandomState(seed)
    d = rs.normal(size=(n, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = np.zeros(n, bool)
    mask[rs.choice(n, valid, replace=False)] = True
    fields = (rs.uniform(0, 640, (n, 2)).astype(np.float32),
              np.full(n, 2.0, np.float32), np.zeros(n, np.float32),
              mask.astype(np.float32), d, mask)
    return (JKeypoints(*(jnp.asarray(f) for f in fields)),
            keypoints_from_numpy(fields, "cpu"))


def codebook(seed):
    """A 16-word vocabulary from another frame's descriptors, as the closer
    builds it from its first frame (built from the same descriptors, its
    centroids are their means and every VLAD residual sum is rounding)."""
    jk, _ = keypoint_pair(seed + 10)
    return JL.kmeans_codebook(
        np.asarray(jk.descriptors)[np.asarray(jk.mask)], 16)


@pytest.mark.parametrize("k", [16, 400], ids=["k16", "k_beyond_n"])
def test_kmeans_codebook_bitwise(k):
    rs = np.random.RandomState(1)
    d = rs.normal(size=(300, 128)).astype(np.float32)
    assert np.array_equal(TL.kmeans_codebook(d, k), JL.kmeans_codebook(d, k))


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_signatures_bitwise(seed):
    jk, tk = keypoint_pair(seed)
    assert np.array_equal(TL.global_descriptor(tk), JL.global_descriptor(jk))
    cb = codebook(seed)
    assert np.array_equal(TL.vlad_signature(tk, cb),
                          JL.vlad_signature(jk, cb))
    empty_t = tk._replace(mask=torch.zeros_like(tk.mask))
    empty_j = jk._replace(mask=jnp.zeros_like(jk.mask))
    assert np.array_equal(TL.vlad_signature(empty_t, cb),
                          JL.vlad_signature(empty_j, cb))


@pytest.mark.parametrize("seed", [0, 1])
def test_vlad_device_matches_jax(seed):
    jk, tk = keypoint_pair(seed)
    cb = codebook(seed)
    ref = np.asarray(JL._vlad_device(jk.descriptors, jk.mask,
                                     jnp.asarray(cb, jnp.float32)))
    got = TL._vlad_device(tk.descriptors, tk.mask,
                          torch.from_numpy(cb.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == (16 * 128,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # The device signature is the host one in float32.
    np.testing.assert_allclose(got.numpy(), TL.vlad_signature(tk, cb),
                               atol=1e-5)


def test_config_converts_and_defaults_match():
    assert params_from_jax(JL.LoopClosureConfig()) == TL.LoopClosureConfig()
    custom = JL.LoopClosureConfig(min_gap=25, min_inliers=40,
                                  rel_pose_samples=300, sim3=False)
    assert params_from_jax(custom) == TL.LoopClosureConfig(
        min_gap=25, min_inliers=40, rel_pose_samples=300, sim3=False)
    assert dataclasses.asdict(params_from_jax(custom)) == \
        dataclasses.asdict(custom)


def test_closer_generator_and_signatures_on_its_device():
    closer = TL.LoopCloser(np.eye(3), device="cpu")
    assert closer._gen.device == torch.device("cpu")
    assert torch.equal(closer._gen.get_state(),
                       torch.Generator().manual_seed(42).get_state())
    assert closer._K.dtype == torch.float32
    ref = JL.LoopCloser(np.eye(3))
    for k in range(3):
        jk, tk = keypoint_pair(k)
        assert closer.add_frame(tk) == ref.add_frame(jk) == k
    assert np.array_equal(closer._codebook, ref._codebook)
    # Frame 0 built the vocabulary, so its own signature is rounding.
    np.testing.assert_allclose(np.stack(closer.signatures[1:]),
                               np.stack(ref.signatures[1:]), atol=1e-5)
    assert closer.detect(2) == ref.detect(2) == []


@pytest.fixture(scope="module")
def loop_run():
    """The reference test's loop (24 keypoint frames on a closed circle)
    through the port's pipeline, the closer fed by the on_accept hook."""
    kps, centers_gt, K = _make_loop_sequence()
    cfg = OdometryConfig(rel_pose_samples=200, pnp_samples=200,
                         rel_pose_min_inliers=40, pnp_min_inliers=15,
                         ba_window=5)
    pipe = OdometryPipeline(K, cfg, device="cpu")
    closer = TL.LoopCloser(K, TL.LoopClosureConfig(
        min_gap=15, min_inliers=40, rel_pose_samples=200), device="cpu")
    pipe.on_accept = lambda kp, vid: closer.add_frame(kp)
    ok = [pipe.process_keypoints(keypoints_from_numpy(kp, "cpu"), f)
          for f, kp in enumerate(kps)]
    accepted = int(sum(ok))
    gt = centers_gt[np.flatnonzero(ok)]
    before = ate_rmse(pipe.pose_graph.trajectory(), gt)
    return dict(pipe=pipe, closer=closer, accepted=accepted, gt=gt,
                before=before, K=K)


def test_loop_closure_reduces_drift(loop_run, tmp_path, monkeypatch):
    r = loop_run
    pipe, closer = r["pipe"], r["closer"]
    assert r["accepted"] >= 22, r["accepted"]
    assert len(closer.signatures) == r["accepted"]
    dump = tmp_path / "pg.npz"
    monkeypatch.setenv("SARA_DUMP_PG", str(dump))
    n_before = pipe.point_cloud.num_points
    assert closer.close(pipe, r["accepted"] - 1), "no loop detected"
    after = ate_rmse(pipe.pose_graph.trajectory(), r["gt"])
    assert after <= r["before"] * 1.05 + 1e-6, (r["before"], after)
    assert after < 0.5, after
    assert closer.loop_edges and all(e[1] == r["accepted"] - 1
                                     for e in closer.loop_edges)
    assert pipe.point_cloud.num_points == n_before
    assert np.isfinite(pipe.point_cloud.points).all()
    # The problem the closer optimized, dumped in the production precision:
    # Sim(3) rows, one fixed pose, the odometry chain then the loop edges.
    with np.load(dump) as pg:
        assert pg["poses"].shape == (r["accepted"], 7)
        assert pg["poses"].dtype == pg["rel_pose"].dtype == np.float32
        assert pg["pose_fixed"].sum() == 1 and pg["pose_fixed"][0]
        assert len(pg["edge_i"]) == len(pipe.pose_graph.edges) + len(
            closer.loop_edges)


def test_e_only_verification_recovers_the_relative_rotation(loop_run):
    """verify(a, b): the E-RANSAC edge between two overlapping frames has
    the ground-truth relative rotation (within 1 deg) and a unit t."""
    closer = loop_run["closer"]
    got = closer.verify(0, 1)
    assert got is not None
    R, t, n_inl = got
    ang = lambda f: 2 * np.pi * f / 24          # noqa: E731
    Rw = lambda a: np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],  # noqa
                             [np.sin(a), 0, np.cos(a)]]).T
    R_gt = Rw(ang(1)) @ Rw(ang(0)).T
    cos = (np.trace(R.T @ R_gt) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
    assert abs(np.linalg.norm(t) - 1.0) < 1e-6 and n_inl >= 40
