"""Port parity: the host-side SfM layer (``sfm/disjoint_sets.py``,
``sfm/tracker.py``, ``sfm/pose_graph.py``, ``sfm/pointcloud.py``,
``utils/metrics.py``, ``viz/html_viewer.py``) and the odometry pipeline
(``sfm/odometry.py``) against their ``sara_tpu`` twins.

The bookkeeping modules are NumPy on both sides and are held bitwise. The
pipeline draws its RANSAC samples from its own generator, so VO runs are
compared by outcome: on the reference's keypoint-level sequence the port's
ATE must be at most the reference's + 0.02 and within the reference
tests' gates (0.15 with 0.3 px noise, 0.02 without). The port runs its
bundle adjustment in float32 (the bfloat16 dense path), the reference
here in float64 (the suite's conftest turns on JAX x64).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sara_tpu.sfm import OdometryConfig as JConfig
from sara_tpu.sfm import OdometryPipeline as JPipeline
from sara_tpu.sfm import disjoint_sets as jds
from sara_tpu.sfm.pointcloud import PointCloudGenerator as JCloud
from sara_tpu.sfm.pose_graph import CameraPoseGraph as JGraph
from sara_tpu.sfm.tracker import FeatureTracker as JTracker
from sara_tpu.utils import metrics as jmetrics
from sara_tpu.viz.html_viewer import write_html_viewer as jwrite_viewer
from sara_tpu_torch.convert import keypoints_from_numpy, params_from_jax
from sara_tpu_torch.core.cameras import Pinhole, undistortion_maps
from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
from sara_tpu_torch.sfm import disjoint_sets as tds
from sara_tpu_torch.sfm.pointcloud import PointCloudGenerator, write_ply
from sara_tpu_torch.sfm.pose_graph import CameraPoseGraph
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.utils import ate_rmse, umeyama_alignment
from sara_tpu_torch.utils.host import fetch
from sara_tpu_torch.viz import write_html_viewer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from render3d import make_room, render  # noqa: E402
from test_sfm_pipeline import _make_sequence  # noqa: E402


def canonical(labels):
    """Labels renumbered in first-occurrence order (a partition's id)."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    return rank[inv]


@pytest.fixture
def numpy_backend(monkeypatch):
    """The port's union-find without its native library."""
    monkeypatch.setattr(tds, "_load_native", lambda: None)


# ---------------------------------------------------------------------------
# union-find
# ---------------------------------------------------------------------------

def test_native_source_is_the_reference_source():
    """The port builds its own copy of the reference's union-find source."""
    assert tds.SOURCE.read_bytes() == (ROOT / "native" /
                                       "sara_native.cpp").read_bytes()


def test_native_backend_builds_into_the_port():
    assert tds.backend() == "native"
    lib = tds._load_native()
    assert Path(lib._name).parent == ROOT / "sara_tpu_torch" / "_build"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_find_native_numpy_and_jax_agree(seed, monkeypatch):
    rs = np.random.RandomState(seed)
    n = 200
    a, b = rs.randint(0, n, 150), rs.randint(0, n, 150)
    ds = tds.DisjointSets(n)
    ds.union_edges(a, b)
    native_roots = ds.components()
    labels, k = tds.connected_components(n, a, b)
    ref_labels, ref_k = jds.connected_components(n, a, b)
    jd = jds.DisjointSets(n)
    jd.union_edges(a, b)
    np.testing.assert_array_equal(native_roots, jd.components())
    np.testing.assert_array_equal(labels, ref_labels)
    assert k == ref_k
    dl, dk = tds.dense_labels(native_roots)
    np.testing.assert_array_equal(dl, jds.dense_labels(native_roots)[0])

    monkeypatch.setattr(tds, "_load_native", lambda: None)
    assert tds.backend() == "numpy"
    ds_np = tds.DisjointSets(n)
    ds_np.union_edges(a, b)
    np.testing.assert_array_equal(ds_np.components(), native_roots)
    np_labels, np_k = tds.connected_components(n, a, b)
    assert np_k == k
    np.testing.assert_array_equal(canonical(np_labels), labels)
    assert tds.make_tracker_core(16) is None


# ---------------------------------------------------------------------------
# tracker, pose graph, point cloud
# ---------------------------------------------------------------------------

def _build_tracker(cls, seed, F=12, N=40):
    rs = np.random.RandomState(seed)
    tr = cls()
    for _ in range(F):
        tr.add_frame(N, rs.randint(0, 4, N).astype(np.float32))
    for f in range(1, F):
        m = rs.randint(5, 15)
        tr.add_matches(f - 1, f, rs.randint(0, N, m), rs.randint(0, N, m))
    tr.add_matches(0, F - 1, rs.randint(0, N, 6), rs.randint(0, N, 6))
    return tr


@pytest.mark.parametrize("seed", range(4))
def test_tracker_incremental_batch_and_jax_agree(seed):
    """Native incremental core == NumPy batch path == the reference's
    tracker, bit for bit (merges, response ties, min-length filter)."""
    for min_len in (2, 3):
        inc = _build_tracker(FeatureTracker, seed)
        bat = _build_tracker(FeatureTracker, seed)
        ref = _build_tracker(JTracker, seed)
        la, ka = inc.compute_tracks(min_len)
        lb, kb = bat._compute_tracks_batch(min_len)
        lr, kr = ref.compute_tracks(min_len)
        assert ka == kb == kr
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(la, lr)
        np.testing.assert_array_equal(inc.rep_of_track, ref.rep_of_track)
        np.testing.assert_array_equal(
            inc.comp_min_gid[inc.component_of_feature],
            bat.comp_min_gid[bat.component_of_feature])
        mi, mr = inc.track_members(), ref.track_members()
        assert mi.keys() == mr.keys()
        for t in mi:
            for x, y in zip(mi[t], mr[t]):
                np.testing.assert_array_equal(x, y)


def test_tracker_interleaved_calls_and_numpy_backend(numpy_backend):
    """Per-frame incremental calls equal one batch call at the end; without
    the native library the tracker takes the batch path."""
    rs = np.random.RandomState(3)
    inc, bat = FeatureTracker(), FeatureTracker()
    for f in range(10):
        resp = rs.randint(0, 3, 30).astype(np.float32)
        inc.add_frame(30, resp)
        bat.add_frame(30, resp)
        if f:
            m = rs.randint(4, 12)
            ia, ib = rs.randint(0, 30, m), rs.randint(0, 30, m)
            inc.add_matches(f - 1, f, ia, ib)
            bat.add_matches(f - 1, f, ia, ib)
        inc.compute_tracks(2)
    la, ka = inc.compute_tracks(2)
    lb, kb = bat._compute_tracks_batch(2)
    assert ka == kb and inc._tk is None
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("cls", [(FeatureTracker, PointCloudGenerator),
                                 (JTracker, JCloud)],
                         ids=["port", "jax"])
def test_track_merge_barycenter_propagation(cls):
    tr_cls, pc_cls = cls
    tr = tr_cls()
    for _ in range(3):
        tr.add_frame(4, np.ones(4, np.float32))
    tr.add_matches(0, 1, np.array([0]), np.array([0]))
    tr.add_matches(1, 2, np.array([1]), np.array([1]))
    tr.compute_tracks(min_length=2)
    pc = pc_cls()
    reps = tr.rep_of_tracks(np.arange(tr.num_tracks))
    pc.add_points(reps, np.array([[0.0, 0.0, 5.0], [2.0, 0.0, 7.0]]),
                  np.array([[1.0, 0, 0], [0, 0, 1.0]]))
    tr.add_matches(0, 1, np.array([0]), np.array([1]))
    tr.compute_tracks(min_length=2)
    pc.propagate(tr)
    assert tr.num_tracks == 1 and len(pc.scene_point_of_track) == 1
    rep = int(tr.rep_of_tracks(np.array([0]))[0])
    np.testing.assert_allclose(pc.point_of_track(rep), [1.0, 0.0, 6.0])
    np.testing.assert_allclose(pc.colors[0], [0.5, 0.0, 0.5])


def test_pose_graph_se3_round_trip_and_jax_twin():
    rs = np.random.RandomState(4)
    from scipy.spatial.transform import Rotation

    g, j = CameraPoseGraph(), JGraph()
    for i in range(5):
        R = Rotation.from_rotvec(rs.normal(scale=0.4, size=3)).as_matrix()
        t = rs.normal(size=3)
        for graph in (g, j):
            graph.add_absolute_pose(R, t, frame_index=i)
            if i:
                graph.add_relative_pose(i - 1, i, R, t, 10 * i, 5 * i)
    packed = g.poses_se3()
    np.testing.assert_array_equal(packed, j.poses_se3())
    np.testing.assert_array_equal(g.trajectory(), j.trajectory())
    assert g.neighbors(2) == j.neighbors(2) == [1, 3]
    moved = packed + rs.normal(scale=0.01, size=packed.shape)
    g.update_from_se3(moved)
    j.update_from_se3(moved)
    np.testing.assert_allclose(g.poses_se3(), moved, atol=1e-12)
    for a, b in zip(g.poses, j.poses):
        np.testing.assert_array_equal(a.matrix(), b.matrix())
    assert len(g) == 5 and g.edges[3].num_inliers == 20


def test_point_cloud_growth_compress_and_ply(tmp_path):
    rs = np.random.RandomState(5)
    xyz = rs.normal(size=(20, 3))
    xyz[3] = np.nan
    xyz[4] = [5e3, 0, 0]                       # beyond DISTANCE_MAX
    cols = rs.rand(20, 3)
    out = []
    for cls in (PointCloudGenerator, JCloud):
        pc = cls()
        kept = pc.add_points(np.arange(20), xyz, cols)
        pc.add_points([0, 21], xyz[:2])       # 0 exists already
        pc.update_points([1, 2], xyz[5:7] + 1)
        pc.compress([1, 2, 5, 21])
        out.append((kept, pc.points, pc.scene_point_of_track))
    assert out[0][0] == out[1][0] == 18
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]
    write_ply(str(tmp_path / "a.ply"), out[0][1])
    text = (tmp_path / "a.ply").read_text()
    assert text.startswith("ply\n") and "element vertex 4\n" in text


def test_metrics_and_viewer_match_jax(tmp_path):
    rs = np.random.RandomState(6)
    gt = rs.normal(size=(30, 3))
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = 0.5 * gt @ R.T + [1.0, 2.0, 3.0] + rs.normal(scale=0.01,
                                                       size=gt.shape)
    for a, b in zip(umeyama_alignment(est, gt), jmetrics.umeyama_alignment(
            est, gt)):
        np.testing.assert_array_equal(a, b)
    assert ate_rmse(est, gt) == jmetrics.ate_rmse(est, gt) < 0.05
    assert np.isnan(ate_rmse(est[:2], gt[:2]))
    pts, cols = rs.normal(size=(60, 3)), rs.rand(60, 3)
    for f in (write_html_viewer, jwrite_viewer):
        f(str(tmp_path / f"{f.__module__}.html"), pts, cols, gt,
          max_points=40)
    texts = {p.read_text() for p in tmp_path.glob("*.html")}
    assert len(texts) == 1 and "const PTS" in texts.pop()


# ---------------------------------------------------------------------------
# the odometry pipeline
# ---------------------------------------------------------------------------

def test_config_converts_and_defaults_match():
    ref = JConfig()
    port = params_from_jax(ref)
    assert port == OdometryConfig()
    assert port.ba_options._asdict() == ref.ba_options._asdict()
    custom = JConfig(rel_pose_samples=200, ba_window=0, full_ba_every=4)
    assert params_from_jax(custom) == OdometryConfig(
        rel_pose_samples=200, ba_window=0, full_ba_every=4)


def test_fetch_is_one_transfer_and_keeps_dtypes():
    xs = (torch.arange(6, dtype=torch.int32).reshape(2, 3),
          torch.tensor([True, False]), torch.tensor(0.25),
          torch.tensor([1.5, -2.0], dtype=torch.float64))
    got = fetch(*xs)
    assert [a.dtype for a in got] == [np.int32, np.bool_, np.float32,
                                      np.float64]
    for a, x in zip(got, xs):
        np.testing.assert_array_equal(a, x.numpy())


def test_pipeline_defaults_to_the_card():
    K = np.eye(3)
    if torch.cuda.is_available():
        assert OdometryPipeline(K).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OdometryPipeline(K)
    assert OdometryPipeline(K, device="cpu")._K.device.type == "cpu"


VO_CASES = {
    # (frames, noise, seed, ba_window, ATE gate): the reference tests'
    # sequences (test_sfm_pipeline.py), 0.3 px noise for the first.
    "noise0.3": (10, 0.3, 0, 6, 0.15),
    "noise0": (8, 0.0, 3, 0, 0.02),
}


@pytest.mark.parametrize("case", list(VO_CASES))
def test_vo_keypoints_against_the_reference(case):
    n, noise, seed, window, gate = VO_CASES[case]
    kps, centers, K = _make_sequence(n_frames=n, n_points=300, noise=noise,
                                     seed=seed)
    cfg = JConfig(rel_pose_samples=200, pnp_samples=200,
                  rel_pose_min_inliers=50, pnp_min_inliers=20,
                  ba_window=window)
    ref = JPipeline(K, cfg)
    ref_ok = [ref.process_keypoints(kp, f) for f, kp in enumerate(kps)]
    port = OdometryPipeline(K, params_from_jax(cfg), device="cpu")
    seen = []
    port.on_accept = lambda kp, v: seen.append((v, kp.xy.device.type))
    ok = [port.process_keypoints(keypoints_from_numpy(kp, "cpu"), f)
          for f, kp in enumerate(kps)]
    assert ok == ref_ok == [True] * n
    assert seen == [(v, "cpu") for v in range(n)]
    ate_ref = ate_rmse(ref.pose_graph.trajectory(), centers)
    ate = ate_rmse(port.trajectory(), centers)
    assert ate <= ate_ref + 0.02 and ate < gate, (ate, ate_ref)
    assert port.point_cloud.num_points > 100
    np.testing.assert_array_equal(port.trajectory(),
                                  port.pose_graph.trajectory())


@pytest.fixture(scope="module")
def room_frames():
    """Five 240x320 renders of the room along the reference's
    test_vo_from_images.py path."""
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    planes = make_room(seed=1)
    imgs, centers = [], []
    for i in range(5):
        ang = 0.02 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([0.25 * i, 0.0, 0.3 * i])
        with np.errstate(invalid="ignore"):
            imgs.append(render(planes, K, R, -R @ c))
        centers.append(c)
    return K, imgs, np.asarray(centers)


def _room_config(**kw):
    return OdometryConfig(rel_pose_samples=300, pnp_samples=300,
                          rel_pose_min_inliers=40, pnp_min_inliers=15,
                          ba_window=6, **kw)


def test_vo_from_pixels_per_frame(room_frames, tmp_path):
    K, imgs, centers = room_frames
    viewer = tmp_path / "live.html"
    pipe = OdometryPipeline(K, _room_config(live_viewer_path=str(viewer),
                                            live_viewer_every=2),
                            device="cpu")
    ok = [bool(pipe.process_frame(img, f)) for f, img in enumerate(imgs)]
    assert sum(ok) >= len(imgs) - 1, ok
    ate = ate_rmse(pipe.trajectory(), centers[np.flatnonzero(ok)])
    assert ate < 0.2, ate
    assert pipe.point_cloud.num_points > 50
    assert viewer.exists() and "const TRAJ" in viewer.read_text()


def test_vo_from_pixels_windowed_with_undistortion(room_frames):
    """process_frames with frontend_batch=2, through identity undistortion
    maps of the pinhole camera (the warp path)."""
    K, imgs, centers = room_frames
    maps = undistortion_maps(Pinhole.from_matrix(K, device="cpu"), 240, 320)
    pipe = OdometryPipeline(K, _room_config(frontend_batch=2),
                            undistortion_maps=maps, device="cpu")
    ok = [bool(o) for o in pipe.process_frames(
        [torch.from_numpy(i) if f % 2 else i for f, i in enumerate(imgs)],
        list(range(len(imgs))))]
    assert len(ok) == len(imgs) and sum(ok) >= len(imgs) - 1, ok
    ate = ate_rmse(pipe.trajectory(), centers[np.flatnonzero(ok)])
    assert ate < 0.2, ate
    assert [p.frame_index for p in pipe.pose_graph.poses] == list(
        np.flatnonzero(ok))
