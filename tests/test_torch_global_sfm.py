"""Port parity: global SfM (``sfm/global_sfm.py``) and its edge scales
(``sfm/edge_scales.py``) against the ``sara_tpu`` twins.

- ``edge_scales`` is NumPy on both sides; the port keeps its own copy, held
  bit for bit (``np.array_equal``).
- Translation averaging (float64, 1e-8) on a graph with an even number of
  edges, where ``jnp.median`` averages the two middle baselines (a lower
  median, as ``torch.median`` takes, rescales every centre); the DLT
  (float64, 1e-6 relative).
- Stage parity: the JAX package's own epipolar graph (its matcher and
  E-RANSAC) feeds both packages' rotation averaging, translation recovery
  and pose-graph polish in float64 (1e-6), and the port's production stages
  (float32) to the end (1e-3 on rotations and centres).
- End to end the pipelines draw their RANSAC samples from different
  generators, so the port is held to the reference tests' outcome gates.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu.ba import BAOptions as JBAOptions
from sara_tpu.core import lie as jlie
from sara_tpu.matching import MatchParams as JMatchParams
from sara_tpu.matching import match_descriptors as jmatch
from sara_tpu.ransac import estimate_relative_pose as jrelpose
from sara_tpu.sfm import edge_scales as jes
from sara_tpu.sfm import global_sfm as JG
from sara_tpu.sfm import pose_graph_opt as JP
from sara_tpu.sfm.rotation_averaging import average_rotations as javg
from sara_tpu_torch.ba import BAOptions
from sara_tpu_torch.convert import keypoints_from_numpy, params_from_jax
from sara_tpu_torch.core import lie as tlie
from sara_tpu_torch.sfm import edge_scales as tes
from sara_tpu_torch.sfm import global_sfm as TG
from sara_tpu_torch.sfm import pose_graph_opt as TP
from sara_tpu_torch.sfm.rotation_averaging import average_rotations as tavg
from sara_tpu_torch.sfm.tracker import FeatureTracker
from sara_tpu_torch.utils import ate_rmse

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_edge_scales import _pose  # noqa: E402
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


# ---------------------------------------------------------------------------
# edge scales (NumPy on both sides: bit for bit)
# ---------------------------------------------------------------------------

def chain_graph(noise, seed=1, V=8):
    """tests/test_edge_scales.py's straight camera row (non-uniform gaps,
    every view paired with the next two), pixels with ``noise`` px."""
    rs = np.random.RandomState(seed)
    gaps = rs.uniform(0.5, 2.0, V - 1)
    cx = np.concatenate([[0.0], np.cumsum(gaps)])
    centers = np.stack([cx, np.zeros(V), np.zeros(V)], 1)
    X = rs.uniform(-3, 3, (200, 3)) + [cx.mean(), 0, 8.0]
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    kp_xy, vis = [], []
    for v in range(V):
        R, t = _pose(centers[v], yaw=0.02 * v)
        Xc = X @ R.T + t
        uv = Xc @ K.T
        uv = uv[:, :2] / Xc[:, 2:3] + rs.normal(scale=noise, size=(200, 2))
        kp_xy.append(uv.astype(np.float32))
        vis.append(Xc[:, 2] > 0)
    edges, edge_R, edge_t, edge_feats = [], [], [], []
    for a in range(V):
        for b in range(a + 1, min(a + 3, V)):
            Ra, ta = _pose(centers[a], yaw=0.02 * a)
            Rb, tb = _pose(centers[b], yaw=0.02 * b)
            R = Rb @ Ra.T
            t = tb - R @ ta
            edges.append((a, b))
            edge_R.append(R)
            edge_t.append(t / np.linalg.norm(t))
            ids = np.arange(len(X))[vis[a] & vis[b]]
            edge_feats.append((ids, ids))
    u = np.stack([(centers[b] - centers[a]) / np.linalg.norm(
        centers[b] - centers[a]) for a, b in edges])
    return edges, edge_R, edge_t, edge_feats, kp_xy, K, u


@pytest.mark.parametrize("noise", [0.0, 0.5], ids=["exact", "noisy"])
def test_edge_scales_bitwise(noise):
    edges, edge_R, edge_t, edge_feats, kp_xy, K, u = chain_graph(noise)
    a, b = edge_feats[0]
    Kinv = np.linalg.inv(K)
    ray = lambda xy: np.c_[xy, np.ones(len(xy))] @ Kinv.T   # noqa: E731
    for x, y in zip(tes.two_view_depths(edge_R[0], edge_t[0],
                                        ray(kp_xy[0][a]), ray(kp_xy[1][b])),
                    jes.two_view_depths(edge_R[0], edge_t[0],
                                        ray(kp_xy[0][a]), ray(kp_xy[1][b]))):
        assert np.array_equal(x, y)
    s = tes.estimate_edge_scales(edges, edge_R, edge_t, edge_feats, kp_xy, K)
    sj = jes.estimate_edge_scales(edges, edge_R, edge_t, edge_feats, kp_xy, K)
    assert np.array_equal(s, sj) and np.mean(s != 1.0) >= 0.5
    c = tes.solve_centers_fixed_scales(len(kp_xy), edges, u, s)
    assert np.array_equal(
        c, jes.solve_centers_fixed_scales(len(kp_xy), edges, u, sj))


# ---------------------------------------------------------------------------
# medians, translation averaging, DLT
# ---------------------------------------------------------------------------

def test_median_is_jnp_median_not_torch_median():
    rs = np.random.RandomState(0)
    for n in (1, 2, 7, 24, 25):
        x = rs.uniform(0.5, 2.0, n)
        got = float(TG._median(torch.from_numpy(x)))
        assert got == float(jnp.median(jnp.asarray(x))) == np.median(x)
        if n % 2 == 0:
            assert float(torch.median(torch.from_numpy(x))) != got


def direction_graph(seed=2, V=10):
    """Centres in a cloud, each view paired with the next three (24 edges,
    an even count), unit baseline directions with 0.02 noise."""
    rs = np.random.RandomState(seed)
    C = rs.normal(size=(V, 3)) * 3
    edges = [(i, j) for i in range(V) for j in range(i + 1, min(i + 4, V))]
    u = np.stack([(C[b] - C[a]) / np.linalg.norm(C[b] - C[a])
                  for a, b in edges])
    u += rs.normal(scale=0.02, size=u.shape)
    return V, edges, u / np.linalg.norm(u, axis=1, keepdims=True)


def port_translation_averaging(V, edges, u, iters):
    """The port's solve in float64 (its host wrapper runs float32)."""
    e = torch.tensor(edges)
    return TG._translation_averaging_jit(e[:, 0], e[:, 1],
                                         torch.from_numpy(u), V,
                                         iters).numpy()


@pytest.mark.parametrize("iters", [0, 6])
def test_translation_averaging_matches_jax(iters):
    """float64 within 1e-8; the float32 host wrapper within 1e-4."""
    V, edges, u = direction_graph()
    assert len(edges) % 2 == 0
    ref = JG._translation_averaging(V, edges, u, iters=iters)
    got = port_translation_averaging(V, edges, u, iters)
    np.testing.assert_allclose(got, ref, atol=1e-8)
    base = np.linalg.norm(got[[e[1] for e in edges]]
                          - got[[e[0] for e in edges]], axis=1)
    assert abs(np.median(base) - 1.0) < 1e-9   # the s_min = 1 gauge
    f32 = TG._translation_averaging(V, edges, u, iters=iters, device="cpu")
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, ref, atol=1e-4)


def test_multiview_triangulate_matches_jax():
    """Random padded tracks (float64), and K-normalised tracks of a real
    scene with masked slots."""
    rs = np.random.RandomState(4)
    P = rs.normal(size=(20, 5, 3, 4))
    uv = rs.normal(size=(20, 5, 2))
    m = rs.rand(20, 5) > 0.3
    m[:, :2] = True
    ref = np.asarray(JG._multiview_triangulate(*map(jnp.asarray, (P, uv, m))))
    got = TG._multiview_triangulate(*map(torch.from_numpy, (P, uv, m)))
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())

    X = rs.uniform(-2, 2, (50, 3)) + [0, 0, 8.0]
    cams = [_pose([0.6 * v, 0.1 * v, 0], yaw=0.05 * v) for v in range(4)]
    P = np.stack([np.c_[R, t] for R, t in cams])           # (4, 3, 4)
    Xc = np.einsum("vij,pj->pvi", P[:, :, :3], X) + P[None, :, :, 3]
    uv = Xc[..., :2] / Xc[..., 2:] + rs.normal(scale=1e-4, size=(50, 4, 2))
    m = np.ones((50, 4), bool)
    m[::3, 3] = False
    Pt = np.broadcast_to(P, (50, 4, 3, 4)).copy()
    ref = np.asarray(JG._multiview_triangulate(*map(jnp.asarray,
                                                    (Pt, uv, m))))
    got = TG._multiview_triangulate(*map(torch.from_numpy, (Pt, uv, m)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * 10)
    assert np.abs(got.numpy() - X).max() < 0.05


# ---------------------------------------------------------------------------
# stage parity on the JAX package's own epipolar graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_graph():
    """The reference's pair stage (pair by pair: match + E-RANSAC) on the
    8-view sequence of tests/test_global_sfm.py."""
    import jax

    kps, centers, K = _make_sequence(n_frames=8, n_points=300, noise=0.3,
                                     seed=1, capacity=512)
    V = len(kps)
    key = jax.random.PRNGKey(0)
    edges, edge_R, edge_t, edge_feats = [], [], [], []
    for a in range(V):
        for b in range(a + 1, V):
            m = jmatch(kps[a], kps[b], JMatchParams(ratio=0.8))
            key, sub = jax.random.split(key)
            res, R, t = jrelpose(sub, kps[a].xy, kps[b].xy[m.j], m.mask,
                                 jnp.asarray(K), jnp.asarray(K),
                                 num_samples=200, min_inliers=30)
            if not bool(res.success):
                continue
            inl = np.asarray(res.inliers) & np.asarray(m.mask)
            t = np.asarray(t, np.float64)
            edges.append((a, b))
            edge_R.append(np.asarray(R, np.float64))
            edge_t.append(t / max(np.linalg.norm(t), 1e-12))
            edge_feats.append((np.asarray(m.i)[inl], np.asarray(m.j)[inl]))
    xy = [np.asarray(k.xy) for k in kps]
    return dict(kps=kps, centers=centers, K=K, V=V, edges=edges,
                edge_R=edge_R, edge_t=edge_t, edge_feats=edge_feats, xy=xy)


def jax_ops():
    def polish(poses6, rel, ok, edges, V):
        prob = JP.PoseGraphProblem(
            poses=jnp.asarray(poses6),
            edge_i=jnp.asarray([e[0] for e in edges], jnp.int32),
            edge_j=jnp.asarray([e[1] for e in edges], jnp.int32),
            rel_pose=jnp.asarray(rel), weight=jnp.ones(len(edges)),
            edge_mask=jnp.asarray(ok),
            pose_fixed=jnp.asarray([True] + [False] * (V - 1)))
        return np.asarray(JP.optimize_pose_graph(prob, max_iters=15)[0].poses)

    return dict(
        avg=lambda V, ei, ej, R: np.asarray(javg(
            V, jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            jnp.asarray(R))),
        scales=jes, ta=lambda V, e, u: JG._translation_averaging(V, e, u, 6),
        log=lambda R: np.asarray(jlie.so3_log(jnp.asarray(R))),
        polish=polish)


def port_ops():
    def polish(poses6, rel, ok, edges, V):
        prob = TP.PoseGraphProblem(
            poses=torch.from_numpy(poses6),
            edge_i=torch.tensor([e[0] for e in edges]),
            edge_j=torch.tensor([e[1] for e in edges]),
            rel_pose=torch.from_numpy(rel),
            weight=torch.ones(len(edges), dtype=torch.float64),
            edge_mask=torch.from_numpy(ok),
            pose_fixed=torch.tensor([True] + [False] * (V - 1)))
        return TP.optimize_pose_graph(prob, max_iters=15)[0].poses.numpy()

    return dict(
        avg=lambda V, ei, ej, R: tavg(V, torch.tensor(ei), torch.tensor(ej),
                                      torch.from_numpy(R)).numpy(),
        scales=tes,
        ta=lambda V, e, u: port_translation_averaging(V, e, u, 6),
        log=lambda R: tlie.so3_log(torch.from_numpy(np.asarray(R))).numpy(),
        polish=polish)


def averaging_stages(ops, g, edge_scale_translation):
    """Stages 3-4b of run_global_sfm (the reference's glue, float64)."""
    V, edges, edge_R, edge_t = g["V"], g["edges"], g["edge_R"], g["edge_t"]
    R_abs = ops["avg"](V, [e[0] for e in edges], [e[1] for e in edges],
                       np.stack(edge_R))
    u = np.stack([-(R_abs[e[1]].T @ t) for e, t in zip(edges, edge_t)])
    if edge_scale_translation:
        s = ops["scales"].estimate_edge_scales(edges, edge_R, edge_t,
                                               g["edge_feats"], g["xy"],
                                               g["K"])
        centers = ops["scales"].solve_centers_fixed_scales(V, edges, u, s)
        base = np.linalg.norm(centers[[e[1] for e in edges]]
                              - centers[[e[0] for e in edges]], axis=1)
        centers = centers / np.median(base[base > 0])
    else:
        centers = ops["ta"](V, edges, u)
    t_abs = np.stack([-R_abs[v] @ centers[v] for v in range(V)])
    poses6 = np.concatenate([ops["log"](R_abs), t_abs], axis=1)
    rel = np.zeros((len(edges), 6))
    ok = np.zeros(len(edges), bool)
    for k, ((a, b), Rr, tu) in enumerate(zip(edges, edge_R, edge_t)):
        s_e = float(np.linalg.norm(centers[b] - centers[a]))
        if s_e >= 1e-9:
            rel[k] = np.concatenate([ops["log"](Rr), s_e * tu])
            ok[k] = True
    return R_abs, centers, ops["polish"](poses6, rel, ok, edges, V)


@pytest.mark.parametrize("edge_scale_translation", [True, False],
                         ids=["edge_scales", "translation_averaging"])
def test_stage_parity_on_the_reference_graph(jax_graph,
                                             edge_scale_translation):
    g = jax_graph
    assert len(g["edges"]) >= g["V"] and len(g["edges"]) % 2 == 0
    R_j, c_j, p_j = averaging_stages(jax_ops(), g, edge_scale_translation)
    R_t, c_t, p_t = averaging_stages(port_ops(), g, edge_scale_translation)
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(c_t, c_j, atol=1e-6)
    np.testing.assert_allclose(p_t, p_j, atol=1e-6)


def test_production_stages_on_the_reference_graph(jax_graph):
    """The port's own stages 3-6 (float32) on the reference's graph: the
    rotations and centres of the float64 stages within 1e-3, then tracks,
    triangulation and BA to the reference test's gates."""
    g = jax_graph
    R_j, c_j, _ = averaging_stages(jax_ops(), g, True)
    tracker = FeatureTracker()
    for kp in g["kps"]:
        tracker.add_frame(kp.capacity, np.asarray(kp.response))
    for (a, b), (fi, fj) in zip(g["edges"], g["edge_feats"]):
        tracker.add_matches(a, b, fi, fj)
    marks = []
    cfg = TG.GlobalSfMConfig(ba_options=BAOptions(max_iters=20))
    out = TG._global_stages(g["V"], g["K"], cfg, torch.device("cpu"),
                            tracker, g["xy"], g["edges"],
                            [r.astype(np.float32) for r in g["edge_R"]],
                            g["edge_t"], g["edge_feats"], marks.append)
    assert marks == ["rotation_averaging", "translation_averaging",
                     "pose_graph_polish", "tracks_triangulation",
                     "bundle_adjustment"]
    np.testing.assert_allclose(out["R_averaged"], R_j, atol=1e-3)
    np.testing.assert_allclose(out["centers_averaged"], c_j, atol=1e-3)
    centers = np.stack([-out["R"][v].T @ out["t"][v] for v in range(g["V"])])
    assert ate_rmse(centers, g["centers"]) < 0.15
    assert len(out["points"]) > 100
    assert out["ba_info"]["final_cost"] <= out["ba_info"]["initial_cost"]


# ---------------------------------------------------------------------------
# end to end, configuration, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_views,chunk", [(8, 0), (7, 8)],
                         ids=["pair_by_pair", "chunked_7_views"])
def test_run_global_sfm_end_to_end(n_views, chunk):
    """tests/test_global_sfm.py's runs in the port: pair by pair on 8 views,
    and chunks of 8 pairs on 7 views (the view axis padded to 8, the last
    chunk's padding slots skipped)."""
    kps, centers_gt, K = _make_sequence(n_frames=n_views, n_points=300,
                                        noise=0.3, seed=1, capacity=512)
    cfg = TG.GlobalSfMConfig(rel_pose_samples=200, min_pair_inliers=30,
                             pair_chunk=chunk,
                             ba_options=BAOptions(max_iters=20))
    out = TG.run_global_sfm([keypoints_from_numpy(k, "cpu") for k in kps],
                            K, config=cfg, device="cpu")
    assert out["num_edges"] >= n_views - 1
    assert len(out["edges"]) == len(out["edge_feats"]) == out["num_edges"]
    centers = np.stack([-out["R"][v].T @ out["t"][v]
                        for v in range(n_views)])
    assert ate_rmse(centers, centers_gt) < 0.15
    assert len(out["points"]) > 100
    assert out["ba_info"]["final_cost"] < out["ba_info"]["initial_cost"]
    assert out["ba_problem"].poses.dtype == torch.float32
    assert set(out["stage_times"]) == {
        "pair_stage", "rotation_averaging", "translation_averaging",
        "pose_graph_polish", "tracks_triangulation", "bundle_adjustment"}


def test_pair_chunk_program_skips_padding():
    kps, _, K = _make_sequence(n_frames=3, n_points=300, noise=0.3, seed=1,
                               capacity=512)
    tk = [keypoints_from_numpy(k, "cpu") for k in kps]
    stack = lambda n: torch.stack([getattr(k, n) for k in tk])  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    j, ok, inl, success, R, t = TG._pair_chunk_program(
        stack("xy"), stack("descriptors"), stack("mask"), [0, 1, None],
        [1, 2, None], gen, torch.tensor(K, dtype=torch.float32), 0.8, 4.0,
        200, 30)
    assert success.tolist() == [True, True, False]
    assert not ok[2].any() and not inl[2].any() and R.shape == (3, 3, 3)


def test_batched_pair_chunk_equals_pair_by_pair(monkeypatch):
    """The chunk as one batched program (a leading pair axis through the
    matcher and the RANSAC engine) against each pair through
    match_descriptors and estimate_relative_pose, with the same sample
    indices injected per pair: identical matches, inliers and success, R
    and t within 1e-5. The geometry runs in float64 here so that the test
    holds the batching and not the rounding: in float32 a batched GEMM
    rounds differently from a single one, and eight Gauss-Newton steps
    carry that to ~1e-4 in t (9.3e-5 on this chunk)."""
    from sara_tpu_torch.matching.brute_force import MatchParams as TMP
    from sara_tpu_torch.matching.brute_force import match_descriptors
    from sara_tpu_torch.ransac import engine as tengine
    from sara_tpu_torch.ransac.estimators import estimate_relative_pose

    kps, _, K = _make_sequence(n_frames=4, n_points=300, noise=0.3, seed=1,
                               capacity=512)
    tk = [keypoints_from_numpy(k, "cpu") for k in kps]
    tk = [k._replace(xy=k.xy.double()) for k in tk]
    stack = lambda n: torch.stack([getattr(k, n) for k in tk])  # noqa: E731
    Kt = torch.tensor(K, dtype=torch.float64)
    ia, ib = [0, 1, 0, None], [1, 2, 3, None]
    draw = tengine.draw_samples
    pending = []

    def injected(gen, S, k, mask):
        if mask.dim() == 2:
            drawn = [draw(torch.Generator().manual_seed(b), S, k, m)
                     for b, m in enumerate(mask)]
            return (torch.stack([d[0] for d in drawn]),
                    torch.stack([d[1] for d in drawn]))
        return draw(torch.Generator().manual_seed(pending.pop(0)), S, k,
                    mask)

    monkeypatch.setattr(tengine, "draw_samples", injected)
    j, ok, inl, success, R, t = TG._pair_chunk_program(
        stack("xy"), stack("descriptors"), stack("mask"), ia, ib,
        torch.Generator(), Kt, 0.8, 4.0, 200, 30)
    assert success.tolist() == [True, True, True, False]
    for b, (a, c) in enumerate(zip(ia[:3], ib[:3])):
        m = match_descriptors(tk[a], tk[c], TMP(ratio=0.8), device="cpu")
        assert torch.equal(m.mask, ok[b])
        assert torch.equal(torch.where(m.mask, m.j, -1),
                           torch.where(ok[b], j[b], -1))
        pending.append(b)
        res, R1, t1 = estimate_relative_pose(
            torch.Generator(), tk[a].xy, tk[c].xy[m.j.long()], m.mask, Kt,
            Kt, threshold_px=4.0, num_samples=200, min_inliers=30)
        assert torch.equal(res.inliers & m.mask, inl[b])
        assert bool(res.success) == bool(success[b])
        assert float((R1 - R[b]).abs().max()) < 1e-5
        assert float((t1 - t[b]).abs().max()) < 1e-5
    assert not pending


def test_city_scale_partitioned_pipeline_on_a_mesh(tmp_path):
    """tests/test_global_sfm.py::test_city_scale_partitioned_pipeline's
    twin: the 48-view city scene with proximity pairs, the partitioned BA
    (4 blocks, 2 sweeps) with its blocks split over a gloo "block" mesh of
    2 ranks (spawned; every rank runs the whole pipeline, ~65 s alone, so
    the world's deadline is 420 s); its gates on every rank: ATE < 2.0,
    > 500 points."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from bench_city_scale_scene import make_city_scene, proximity_pairs

    import torch_dist

    V = 48
    kps, centers_gt, K = make_city_scene(V, capacity=256)
    pairs = proximity_pairs(centers_gt)
    kps_np = [tuple(np.asarray(f) for f in k) for k in kps]
    res = torch_dist.run_world(
        torch_dist.global_sfm_worker, 2, tmp_path, kps_np, K, pairs,
        dict(rel_pose_samples=128, min_pair_inliers=20, pair_chunk=32,
             ba_blocks=4, ba_sweeps=2), dict(max_iters=10), deadline=420.0)
    for r in res:
        centers = np.stack([-r["R"][v].T @ r["t"][v] for v in range(V)])
        assert ate_rmse(centers, centers_gt) < 2.0
        assert len(r["points"]) > 500
        assert np.isfinite(r["points"]).all()
    np.testing.assert_array_equal(res[0]["R"], res[1]["R"])
    np.testing.assert_array_equal(res[0]["points"], res[1]["points"])


def test_config_converts_and_defaults_match():
    ref = JG.GlobalSfMConfig()
    assert params_from_jax(ref) == TG.GlobalSfMConfig()
    custom = JG.GlobalSfMConfig(rel_pose_samples=256, min_pair_inliers=20,
                                pair_chunk=32,
                                ba_options=JBAOptions(max_iters=40))
    port = params_from_jax(custom)
    assert port == TG.GlobalSfMConfig(rel_pose_samples=256,
                                      min_pair_inliers=20, pair_chunk=32,
                                      ba_options=BAOptions(max_iters=40))
    assert port.ba_options._asdict() == custom.ba_options._asdict()
    assert {f.name for f in dataclasses.fields(port)} == {
        f.name for f in dataclasses.fields(ref)}
