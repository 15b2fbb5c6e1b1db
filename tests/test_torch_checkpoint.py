"""Port parity: checkpoint / resume (``io/checkpoint.py``) against its
``sara_tpu`` twin.

The port keeps the reference's NPZ layout; where the reference stores its
PRNG key, the port stores the pipeline generator's state (uint8). A
restored pipeline must process the remaining frames exactly as the
uninterrupted run does (trajectories within 1e-6, the reference test's
tolerance, tests/test_misc_modules.py::
test_checkpoint_resume_matches_uninterrupted).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sara_tpu.io import save_sfm_state as jsave
from sara_tpu.sfm import OdometryConfig as JConfig
from sara_tpu.sfm import OdometryPipeline as JPipeline
from sara_tpu_torch.convert import keypoints_from_numpy
from sara_tpu_torch.io import load_sfm_state, save_sfm_state
from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_sfm_pipeline import _make_sequence  # noqa: E402

CFG = dict(rel_pose_samples=100, pnp_samples=100, rel_pose_min_inliers=30,
           pnp_min_inliers=15)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the machine's cores, and torch's default of a thread per core makes
    the port's many small operations wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    kps, centers, K = _make_sequence(n_frames=8, noise=0.1)
    return [keypoints_from_numpy(k, "cpu") for k in kps], kps, K


def run(pipe, kps, frames):
    for f in frames:
        assert pipe.process_keypoints(kps[f], f), f"frame {f} rejected"
    return pipe


def test_round_trip_restores_the_whole_state(sequence, tmp_path):
    kps, _, K = sequence
    cfg = OdometryConfig(full_ba_every=3, **CFG)
    pipe = run(OdometryPipeline(K, cfg, device="cpu"), kps, range(4))
    path = str(tmp_path / "state.npz")
    save_sfm_state(path, pipe)
    back = load_sfm_state(path, OdometryPipeline(K, cfg, device="cpu"))
    np.testing.assert_array_equal(back.trajectory(), pipe.trajectory())
    np.testing.assert_array_equal(back.point_cloud.points,
                                  pipe.point_cloud.points)
    np.testing.assert_array_equal(back.point_cloud.colors,
                                  pipe.point_cloud.colors)
    assert back.point_cloud.scene_point_of_track == \
        pipe.point_cloud.scene_point_of_track
    assert torch.equal(back._gen.get_state(), pipe._gen.get_state())
    for a, b in zip(back._prev_keypoints, pipe._prev_keypoints):
        assert torch.equal(a, b) and a.device == pipe.device
    assert [e.src for e in back.pose_graph.edges] == [
        e.src for e in pipe.pose_graph.edges]
    np.testing.assert_array_equal(back.tracker.track_of_feature,
                                  pipe.tracker.track_of_feature)
    assert back._frames_since_ba == pipe._frames_since_ba
    assert back._frames_since_full_ba == pipe._frames_since_full_ba
    for fa, fb in zip(back.frames, pipe.frames):
        assert fa["tracker_id"] == fb["tracker_id"]
        for k in ("xy", "scale", "response", "mask"):
            np.testing.assert_array_equal(fa["kp"][k], fb["kp"][k])


RESUME_CASES = {
    # (configuration, frames before the checkpoint)
    "plain": (dict(), 4),
    # The full-BA beat: the counter is 1 at the checkpoint, and a BA window
    # of 3 makes a full BA differ from a windowed one, so a resume that
    # restarted the beat would run its full BA on another frame.
    "full_ba_beat": (dict(full_ba_every=3, ba_window=3), 5),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_equals_uninterrupted(sequence, tmp_path, case):
    """8 frames straight against k, save, load into a FRESH pipeline, the
    rest: the same trajectory (1e-6) and map size."""
    kps, _, K = sequence
    kw, k = RESUME_CASES[case]
    cfg = OdometryConfig(**kw, **CFG)
    ref = run(OdometryPipeline(K, cfg, device="cpu"), kps, range(8))
    pipe = run(OdometryPipeline(K, cfg, device="cpu"), kps, range(k))
    path = str(tmp_path / "mid.npz")
    save_sfm_state(path, pipe)
    resumed = load_sfm_state(path, OdometryPipeline(K, cfg, device="cpu"))
    assert resumed._frames_since_full_ba == pipe._frames_since_full_ba
    run(resumed, kps, range(k, 8))
    assert resumed.trajectory().shape == ref.trajectory().shape
    np.testing.assert_allclose(resumed.trajectory(), ref.trajectory(),
                               atol=1e-6)
    assert resumed.point_cloud.num_points == ref.point_cloud.num_points


def test_layout_is_the_reference_layout(sequence, tmp_path):
    """Same arrays and meta keys as the reference's checkpoint of the same
    frames (the port adds the full-BA counter); only the generator state
    differs in kind, and a reference file is refused before anything of
    the pipeline changes."""
    kps, jkps, K = sequence
    port = run(OdometryPipeline(K, OdometryConfig(**CFG), device="cpu"),
               kps, range(3))
    ref = JPipeline(K, JConfig(**CFG))
    for f in range(3):
        assert ref.process_keypoints(jkps[f], f)
    save_sfm_state(str(tmp_path / "port.npz"), port)
    jsave(str(tmp_path / "ref.npz"), ref)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k not in ("prng_key", "meta"):
                assert a[k].shape[1:] == b[k].shape[1:], k
        assert a["prng_key"].dtype == np.uint8
        meta_a = json.loads(bytes(a["meta"]).decode())
        meta_b = json.loads(bytes(b["meta"]).decode())
        assert set(meta_a) - set(meta_b) == {"frames_since_full_ba"}
        assert set(meta_b) <= set(meta_a)
    fresh = OdometryPipeline(K, OdometryConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="PRNG key"):
        load_sfm_state(str(tmp_path / "ref.npz"), fresh)
    assert len(fresh.pose_graph) == 0 and fresh._prev_keypoints is None
    # A generator state of another size (another device type's generator).
    with np.load(tmp_path / "port.npz") as a:
        arrays = dict(a)
    arrays["prng_key"] = arrays["prng_key"][:16]
    np.savez(tmp_path / "other.npz", **arrays)
    with pytest.raises(ValueError, match="generator state of 16 bytes"):
        load_sfm_state(str(tmp_path / "other.npz"), fresh)
    assert len(fresh.pose_graph) == 0
