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
here in float64 (the suite's conftest turns on JAX x64), and once, on the
noisy sequence, in a subprocess without x64, as its users run it (that
run's recording, ``tool_twins.Reference``, where its fingerprint matches
the tree).
"""

import json
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
import tool_twins  # noqa: E402
from render3d import make_room, render  # noqa: E402
from test_sfm_pipeline import _make_sequence  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the machine's cores, and torch's default of a thread per core makes
    the port's many small operations wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# Time limit (s) of the reference's VO run where it runs live: about
# three times its wall time in the loaded suite, at least 120 s.
REFERENCE_VO_SECONDS = 670
# The reference's VO as its users run it: JAX without x64 (in this suite's
# x64 it builds its BA problem, and more, in float64), in a subprocess on
# the noisy sequence's keypoints (``_make_sequence``'s float32 arrays, as
# the tests stack them); prints its acceptances and trajectory as one JSON
# line.
REFERENCE_VO_WITHOUT_X64 = """
import json
import jax
import jax.numpy as jnp
import numpy as np
from sara_tpu.core.types import Keypoints
from sara_tpu.sfm import OdometryConfig, OdometryPipeline
from test_sfm_pipeline import _make_sequence
n, noise, seed, window, _ = {case!r}
kps, _, K = _make_sequence(n_frames=n, n_points=300, noise=noise, seed=seed)
d = dict(K=K, window=window, **{{
    f: np.stack([np.asarray(getattr(kp, f)) for kp in kps])
    for f in kps[0]._fields}})
cfg = OdometryConfig(rel_pose_samples=200, pnp_samples=200,
                     rel_pose_min_inliers=50, pnp_min_inliers=20,
                     ba_window=int(d["window"]))
pipe = OdometryPipeline(d["K"], cfg)
ok = [bool(pipe.process_keypoints(Keypoints(*(jnp.asarray(d[f][i])
                                              for f in Keypoints._fields)), i))
      for i in range(len(d["xy"]))]
print(json.dumps({{"ok": ok,
                   "trajectory": pipe.pose_graph.trajectory().tolist(),
                   "x64": bool(jax.config.jax_enable_x64)}}))
"""
REFERENCE_VO = tool_twins.jax_reference(
    "sfm.vo_without_x64",
    REFERENCE_VO_WITHOUT_X64.format(case=VO_CASES["noise0.3"]),
    REFERENCE_VO_SECONDS)


@pytest.fixture(scope="module", autouse=True)
def reference_vo_without_x64():
    """The reference's run on the noisy sequence without x64
    (``REFERENCE_VO``): its recording, or, where that is stale, the run
    started in a subprocess when this module starts, so that it runs
    beside the module's first tests, and killed at the end if no test
    read it."""
    run = REFERENCE_VO.start()
    yield run
    run.kill()


@pytest.mark.parametrize("case", list(VO_CASES) + ["noise0.3-without-x64"])
def test_vo_keypoints_against_the_reference(case, reference_vo_without_x64):
    """``-without-x64``: the reference runs as its users run it (F9), in
    the subprocess this module started."""
    base, _, without_x64 = case.partition("-")
    n, noise, seed, window, gate = VO_CASES[base]
    kps, centers, K = _make_sequence(n_frames=n, n_points=300, noise=noise,
                                     seed=seed)
    cfg = JConfig(rel_pose_samples=200, pnp_samples=200,
                  rel_pose_min_inliers=50, pnp_min_inliers=20,
                  ba_window=window)
    if not without_x64:
        ref = JPipeline(K, cfg)
        ref_ok = [ref.process_keypoints(kp, f) for f, kp in enumerate(kps)]
        ref_traj = ref.pose_graph.trajectory()
    port = OdometryPipeline(K, params_from_jax(cfg), device="cpu")
    seen = []
    port.on_accept = lambda kp, v: seen.append((v, kp.xy.device.type))
    ok = [port.process_keypoints(keypoints_from_numpy(kp, "cpu"), f)
          for f, kp in enumerate(kps)]
    if without_x64:
        out = json.loads(
            reference_vo_without_x64.output().text.strip().splitlines()[-1])
        assert out["x64"] is False
        ref_ok, ref_traj = out["ok"], np.asarray(out["trajectory"])
    assert ok == ref_ok == [True] * n
    assert seen == [(v, "cpu") for v in range(n)]
    ate_ref = ate_rmse(ref_traj, centers)
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


# F9's witness (tests/vo_gap_witness.py, ROADMAP §3): ATE of the batched
# VO on the A/B probe's 20 room frames at 240x320, seeds 0-47, on the CPU
# (the reference without x64), as recorded on an 8-core Intel Xeon.
F9_REFERENCE_ATE = [
    0.0124, 0.0303, 0.0653, 0.0103, 0.0587, 0.1963, 0.0056, 0.0068, 0.022,
    0.0073, 0.0583, 0.0657, 0.0097, 0.0689, 0.0113, 0.0837, 0.0317, 0.087,
    0.0416, 0.0144, 0.0649, 0.0968, 0.0097, 0.0215, 0.0228, 0.0082, 0.0089,
    0.0138, 0.0134, 0.0232, 0.0065, 0.0377, 0.0112, 0.0179, 0.0773, 0.0629,
    0.054, 0.0859, 0.0806, 0.0369, 0.0209, 0.0672, 0.0548, 0.0233, 0.0232,
    0.0319, 0.064, 0.0793]
F9_PORT_ATE = [
    0.0429, 0.0818, 0.187, 0.0827, 0.0722, 0.0262, 0.0562, 0.0803, 0.0889,
    0.1851, 0.0353, 0.0184, 0.4707, 0.0195, 0.1001, 0.071, 0.0293, 0.088,
    0.0233, 0.0595, 0.0601, 0.0574, 0.0623, 0.0126, 0.0294, 0.0087, 0.0635,
    0.0672, 0.0195, 0.0289, 0.0052, 0.059, 0.0205, 0.0201, 0.0655, 0.0076,
    0.069, 0.0113, 0.0971, 0.1491, 0.0565, 0.2436, 0.0259, 0.0635, 0.0269,
    0.2045, 0.0648, 0.0191]
# The port with its E-RANSAC hypotheses solved in float32 (tried, not
# kept): further from the reference, not closer.
F9_PORT_FLOAT32_SOLVE_ATE = [
    0.0706, 0.0668, 0.1058, 0.0827, 0.0722, 0.0762, 0.0622, 0.064, 0.0812,
    0.1557, 0.0326, 0.0858, 0.4715, 0.0186, 0.1001, 0.071, 0.0105, 0.0082,
    0.0733, 0.0595, 0.0082, 0.0574, 0.0623, 0.062, 0.5195, 0.0591, 0.0356,
    0.0672, 0.0103, 0.0572, 0.1836, 0.0551, 0.0365, 0.0861, 0.0655, 0.0734,
    0.069, 0.0203, 0.011, 0.0704, 0.0179, 0.0995, 0.0244, 0.0459, 0.0275,
    0.0834, 0.0648, 0.0072]
F9_RULE_CASES = {
    # port sample, expected decision, (lo, hi) bounds on p
    "recorded": (F9_PORT_ATE, False, (0.01, 0.05)),
    "float32_solve": (F9_PORT_FLOAT32_SOLVE_ATE, True, (0.0, 0.01)),
    "tripled": ([3 * a for a in F9_REFERENCE_ATE], True, (0.0, 1e-5)),
    "same": (F9_REFERENCE_ATE, False, (0.99, 1.0)),
}


@pytest.mark.parametrize("case", list(F9_RULE_CASES))
def test_vo_gap_witness_decision_rule(case):
    """The witness's rule on recorded numbers: a gap is real where the
    two-sided Mann-Whitney p < 0.01 and the bootstrap 95% interval of the
    port / reference median ratio excludes 1. The recorded 48 seeds have
    the port's median at 1.91 x the reference's, p = 0.022, and an
    interval that holds 1: no real gap."""
    from vo_gap_witness import compare

    port, real, (lo, hi) = F9_RULE_CASES[case]
    got = compare(port, F9_REFERENCE_ATE)
    assert got["real"] is real
    assert lo <= got["p"] <= hi
    c_lo, c_hi = got["ratio_ci95"]
    assert got["real"] == (got["p"] < 0.01 and not c_lo <= 1.0 <= c_hi)
    assert c_lo <= got["ratio"] <= c_hi
    if case == "recorded":
        assert got["median"] == [0.05925, 0.031]
        assert c_lo < 1.0 < c_hi


@pytest.mark.parametrize("tdir, cheiral, matches, expected", [
    (4.44, 248, 248, "G"), (81.86, 142, 248, "B"), (175.6, 0, 248, "F"),
    (25.46, 248, 248, "M"), (74.35, 157, 248, "B")])
def test_vo_gap_witness_bootstrap_classes(tdir, cheiral, matches, expected):
    """The bootstrap pair's outcome classes on recorded frame-1 numbers of
    the witness's runs (translation-direction error in degrees, cheirality
    survivors of the 248 matches)."""
    from vo_gap_witness import bootstrap_class

    assert bootstrap_class(tdir, cheiral, matches) == expected


# F10's witness (tests/config5_witness.py, ROADMAP §3): config 5's ATE at
# 32 views (bench_config5_real's cut in phase "tools"), seeds 0-47, on the
# CPU (the reference without x64, the port with one torch thread), as
# recorded on an 8-core Intel Xeon.
F10_REFERENCE_ATE = [
    0.1435, 0.0785, 0.07, 0.0743, 0.0805, 0.0941, 0.1235, 0.1106, 0.0803,
    0.0787, 0.0856, 0.0745, 0.133, 0.0744, 0.068, 0.1142, 0.0806, 0.0857,
    0.0707, 0.076, 0.0885, 0.0746, 0.0593, 0.0792, 0.0969, 0.0702, 0.1978,
    0.0765, 0.1159, 0.0372, 0.0936, 0.0787, 0.0867, 0.0797, 0.1578, 0.0933,
    0.0768, 0.06, 0.0821, 0.0599, 0.0572, 0.086, 0.1551, 0.0377, 0.057,
    0.0583, 0.0813, 0.0945]
F10_PORT_ATE = [
    0.0765, 0.0795, 0.0972, 0.0766, 0.0727, 0.0874, 0.0647, 0.0849, 0.0909,
    0.0774, 0.1148, 0.0735, 0.0777, 0.09, 0.0573, 0.081, 0.0463, 0.0881,
    0.0947, 0.0956, 0.0842, 0.0823, 0.0702, 0.0768, 0.0407, 0.0756, 0.1172,
    0.0963, 0.0724, 0.0495, 0.0836, 0.0535, 0.1031, 0.0796, 0.0952, 0.0844,
    0.1096, 0.0689, 0.0937, 0.0697, 0.1079, 0.0724, 0.0632, 0.0765, 0.0975,
    0.0842, 0.0874, 0.0637]
# One BA problem of the port (the card's seed-0 pair stage replayed on the
# CPU, rotation averaging's output turned by 3e-5 rad, turn 47) solved
# again by each package's partitioned BA with lambda_init x (1 + j 1e-6),
# j = -12..12 (``config5_witness.py lambda``): both end above the gate in
# about a quarter of the runs.
F10_LAMBDA_REFERENCE_BA_ATE = [
    0.1162, 0.8286, 0.105, 1.538, 0.0989, 0.0878, 0.0817, 1.0062, 1.3104,
    1.2988, 0.0959, 0.0901, 0.1157, 0.1017, 0.093, 1.3029, 0.0824, 1.5533,
    0.0969, 0.1049, 0.0862, 0.1073, 0.0887, 0.093, 0.099]
F10_LAMBDA_PORT_BA_ATE = [
    0.1008, 1.3205, 1.573, 0.1004, 1.2624, 0.0983, 0.0938, 1.5722, 0.0875,
    0.7556, 0.094, 0.0955, 1.1329, 0.0876, 0.0956, 0.0884, 0.1017, 0.0985,
    0.1052, 0.09, 0.0994, 0.0867, 0.0911, 0.0946, 0.0864]
F10_RULE_CASES = {
    # port sample, reference sample, expected decision, (lo, hi) on p
    "recorded": (F10_PORT_ATE, F10_REFERENCE_ATE, False, (0.5, 1.0)),
    "tripled": ([3 * a for a in F10_REFERENCE_ATE], F10_REFERENCE_ATE,
                True, (0.0, 1e-5)),
    "same": (F10_REFERENCE_ATE, F10_REFERENCE_ATE, False, (0.99, 1.0)),
    "lambda_jitter": (F10_LAMBDA_PORT_BA_ATE, F10_LAMBDA_REFERENCE_BA_ATE,
                      False, (0.5, 1.0)),
}


@pytest.mark.parametrize("case", list(F10_RULE_CASES))
def test_config5_witness_decision_rule(case):
    """The config-5 witness's decision on recorded numbers
    (``config5_witness.decide``: F9's rule, p < 0.01 and a median-ratio
    interval without 1, plus each package's share above the tool gate's
    0.5, with the Fisher p of those shares). The recorded 48 seeds:
    medians 0.0803 (port) and 0.0800, no
    real gap, no run above the gate in either package. The BA problem
    solved again under lambda jitters: 6 of 25 above the gate with the
    port's BA, 7 of 25 with the reference's (F6's mechanism)."""
    from config5_witness import GATE, decide

    port, ref, real, (lo, hi) = F10_RULE_CASES[case]
    got = decide(port, ref)
    assert got["real"] is real
    assert lo <= got["p"] <= hi
    c_lo, c_hi = got["ratio_ci95"]
    assert got["real"] == (got["p"] < 0.01 and not c_lo <= 1.0 <= c_hi)
    assert GATE == 0.5
    if case == "recorded":
        assert np.allclose(got["median"], [0.0803, 0.08], atol=1e-12)
        assert got["share_above_gate"] == [0.0, 0.0]
        assert got["share_p"] == 1.0
        assert c_lo < 1.0 < c_hi
    if case == "lambda_jitter":
        assert got["share_above_gate"] == [6 / 25, 7 / 25]
        assert got["share_p"] == 1.0


def _f10_digest(kp_hash, edges_hash, rot, ate_avg, ate_pol, ba, ate):
    return {"kp": {"exact": kp_hash, "hash": "c7438b37394cccc3"},
            "edges_hash": edges_hash, "rot_mean_deg": rot,
            "ate_averaged": ate_avg, "ate_polished": ate_pol, "ba": ba,
            "ate": ate}


# Card digests of config 5 (NVIDIA H100 80GB HBM3, 700.00 W), trimmed to
# the fields the witness compares: the first seed-0 run alone, the run of
# 30 that ended above the gate, the run after phase "tools"' earlier
# tools, the run inside the whole chip script, and seed 1.
F10_CARD = {
    "alone": _f10_digest("70e895fe278dc58d", "483c8500d2ea36eb", 2.096717,
                         0.076556, 0.094215, [23562.5, 20386.3], 0.0937),
    "above_gate": _f10_digest("70e895fe278dc58d", "483c8500d2ea36eb",
                              2.107085, 0.076556, 0.094224,
                              [67256.4, 64350.7], 1.5238),
    "after_tools": _f10_digest("70e895fe278dc58d", "483c8500d2ea36eb",
                               2.103956, 0.076556, 0.094224,
                               [24500.8, 21724.3], 0.1031),
    "script": _f10_digest("70e895fe278dc58d", "483c8500d2ea36eb", 2.099931,
                          0.076556, 0.094225, [23590.2, 20310.6], 0.0999),
    "seed1": _f10_digest("70e895fe278dc58d", "2fafedc890f1cb7a", 1.192715,
                         0.07035, 0.080534, [6875.2, 6571.5], 0.0863),
}


@pytest.mark.parametrize("run, stage", [
    ("alone", None), ("above_gate", "rot_mean_deg"),
    ("after_tools", "rot_mean_deg"), ("script", "rot_mean_deg"),
    ("seed1", "edges_hash")])
def test_config5_witness_parting_stage(run, stage):
    """Where each recorded card run parts from the first seed-0 run alone:
    every seed-0 run, after the preceding tools and inside the whole
    script too, has the same keypoints (exact hash) and verified edges, so
    neither detection (state carried over from earlier phases) nor the
    pair stage's draws differ; the runs part at rotation averaging (the
    card's atomic sums), and the one above the gate only after it."""
    from config5_witness import GATE, parting_stage

    assert parting_stage(F10_CARD["alone"], F10_CARD[run]) == stage
    assert (F10_CARD[run]["ate"] > GATE) == (run == "above_gate")


def test_config5_witness_rotation_jitter():
    """The replay's rotation jitter: k = 0 leaves rotation averaging's
    output as it is; k > 0 turns each view by a rotation of the given
    per-axis spread (a mean angle of about 1.6 x 3e-5 rad), the result
    still orthonormal; seed ranges may be negative (``lambda`` jitters)."""
    from config5_witness import _seeds, gt_rotations, jittered

    R = gt_rotations().astype(np.float32)
    assert jittered(R, 0) is R
    J = jittered(R, 3, 3e-5).astype(np.float64)
    np.testing.assert_allclose(J @ J.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), J.shape),
                               atol=1e-6)
    # Small angles from the skew part (arccos loses them to float32).
    M = J @ R.astype(np.float64).transpose(0, 2, 1)
    ang = 0.5 * np.linalg.norm(np.stack([M[:, 2, 1] - M[:, 1, 2],
                                         M[:, 0, 2] - M[:, 2, 0],
                                         M[:, 1, 0] - M[:, 0, 1]], 1), axis=1)
    assert 2e-5 < np.mean(ang) < 8e-5
    assert _seeds("-2-1") == [-2, -1, 0, 1] and _seeds("5") == [5]
