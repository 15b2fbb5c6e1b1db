"""Card-only tests of the port's CUDA kernels, of Slice B's estimators, of
Slice C's bundle adjustment and odometry core, of Slice D's pose-graph
optimizer, rotation averaging, checkpoints and global SfM, of Slice E's
chessboard device program, calibration LM and Hough lines, of the E3
modules and the demo twins, of the bench twin's counts and of the batched
frontend (K1 on the frame-folded field) on the card (marker ``cuda``).

They skip without a CUDA device. This file imports nothing of JAX, so on a
GPU machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sara_tpu_torch.features import sift
from sara_tpu_torch.ops import patch_sampler as ps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(seed, S, H, W, K, N=16, C=36, rad=20.0, edge=False,
             index=np.int32):
    rs = np.random.RandomState(seed)
    maps = rs.rand(S, H, W, C).astype(np.float32)
    pins = lambda n: rs.choice([0.0, 1.0, n - 2.0, n - 1.0], K)
    cy = pins(H) if edge else rs.uniform(0, H - 1, K)
    cx = pins(W) if edge else rs.uniform(0, W - 1, K)
    ys = (cy[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    xs = (cx[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    si = rs.randint(0, S, K).astype(index)
    return [torch.from_numpy(a) for a in (maps, si, ys, xs)]


def _counts():
    return (ps.LAUNCHES, ps.GENERAL_LAUNCHES, ps.PACKED_LAUNCHES,
            ps.PACKED_GENERAL_LAUNCHES)


def _moved(before, packed, vector):
    """The counts after one launch of the named kernel and variant."""
    after = list(before)
    after[2 * packed + (not vector)] += 1
    return tuple(after)


def _misaligned(maps):
    """A contiguous view of ``maps``'s values whose base address is one
    element past an aligned one (a sliced view of a flat buffer)."""
    flat = torch.empty(maps.numel() + 1, dtype=maps.dtype,
                       device=maps.device)
    view = flat[1:].view(maps.shape)
    view.copy_(maps)
    return view


# Variant cases: problem, dtype and layout, and the variant the wrapper
# must take. Widths are multiples of 16, so pack_x takes K2.
VARIANT_CASES = {
    "c36_f32": (dict(S=5, H=960, W=1280, K=5120, index=np.int64), True),
    "c36_bf16": (dict(S=5, H=960, W=1280, K=5120, index=np.int64), True),
    "c37": (dict(S=3, H=64, W=96, K=40, C=37), False),
    "misaligned": (dict(S=3, H=64, W=96, K=40), False),
    "last_row_and_column": (dict(S=3, H=64, W=96, K=40), True),
    "odd_and_even_x0": (dict(S=3, H=64, W=96, K=40), True),
    "int32_idx": (dict(S=3, H=64, W=96, K=40, index=np.int32), True),
    "int64_idx": (dict(S=3, H=64, W=96, K=40, index=np.int64), True),
    "k13": (dict(S=5, H=30, W=48, K=13), True),
}


def _variant_problem(case, cuda):
    kw, vector = VARIANT_CASES[case]
    maps, si, ys, xs = (t.to(cuda) for t in _problem(11, **kw))
    H, W = maps.shape[1:3]
    if case == "c36_bf16":
        maps = maps.bfloat16()
    elif case == "misaligned":
        maps = _misaligned(maps)
    elif case == "last_row_and_column":
        ys[:, :4] = H - 1.0                    # y exactly at the last row
        xs[:, 4:8] = W - 1.0                   # x exactly at the last column
        ys[:, 8], xs[:, 8] = H - 1.0, W - 1.0
        xs[:, 9] = W - 1.5                     # even x0 = W - 2
        xs[:, 10] = W - 2.5                    # odd x0 = W - 3
    elif case == "odd_and_even_x0":
        cols = torch.arange(16, device=cuda, dtype=torch.float32)
        xs[:] = 20.0 + cols * 0.75             # odd and even x0, fx 0 to .75
    return maps, si, ys, xs, vector


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_variants_match_plain_on_card(cuda, case, packed):
    """The wrapper takes the vector variant exactly where
    ``vector_layout_ok`` holds, and the general variant elsewhere; each
    variant that can read the layout equals the plain version of its kernel
    (max abs error <= 1e-5). The index is read as it comes."""
    maps, si, ys, xs, vector = _variant_problem(case, cuda)
    assert ps.vector_layout_ok(maps) is vector
    plain = (ps._sample_patches_packed_reference if packed
             else ps._sample_patches_reference)
    ref = plain(maps, si, ys, xs)
    before = _counts()
    copies = ps.INDEX_COPIES
    out = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7,
                                  pack_x=packed)
    torch.cuda.synchronize()
    assert _counts() == _moved(before, packed, vector)
    assert ps.INDEX_COPIES == copies
    assert (out - ref).abs().max().item() <= 1e-5
    if vector:                                 # the general variant too
        before = _counts()
        out = ps._launch(maps, si, ys, xs, packed=packed, vector=False)
        torch.cuda.synchronize()
        assert _counts() == _moved(before, packed, False)
        assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
def test_nan_coordinates_vector_equals_general_on_card(cuda, packed):
    """A NaN coordinate reads the first row or column in both variants
    (the plain version has no answer for NaN)."""
    maps, si, ys, xs = (t.to(cuda) for t in _problem(12, S=3, H=64, W=96,
                                                     K=40))
    ys[::3, 0] = float("nan")
    xs[::2, 1] = float("nan")
    ys[1::4, 2] = xs[1::4, 2] = float("nan")
    new = ps._launch(maps, si, ys, xs, packed=packed, vector=True)
    old = ps._launch(maps, si, ys, xs, packed=packed, vector=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(new).all())
    assert (new - old).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["octave0", "octave0_edge", "k13",
                                  "octave0_bf16"])
def test_kernel_matches_plain_on_card(cuda, case):
    """K1 against its plain version, max abs error <= 1e-5."""
    shape = dict(S=5, H=960, W=1280, K=5120)
    if case == "k13":
        shape = dict(S=5, H=30, W=40, K=13)
    maps, si, ys, xs = (t.to(cuda) for t in _problem(
        5, **shape, edge=case.endswith("edge")))
    if case.endswith("bf16"):
        maps = maps.bfloat16()
    before = ps.LAUNCHES
    out = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7)
    torch.cuda.synchronize()
    assert ps.LAUNCHES == before + 1
    ref = ps._sample_patches_reference(maps, si, ys, xs)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["octave0", "octave0_edge", "k13",
                                  "octave0_bf16"])
def test_packed_kernel_matches_plain_and_k1_on_card(cuda, case):
    """K2 (pack_x=True, W % 16 == 0, 2C <= 128) against its plain version
    and against K1 (the same function), max abs error <= 1e-5."""
    shape = dict(S=5, H=960, W=1280, K=5120)
    if case == "k13":
        shape = dict(S=5, H=30, W=48, K=13)
    maps, si, ys, xs = (t.to(cuda) for t in _problem(
        8, **shape, edge=case.endswith("edge")))
    if case.endswith("bf16"):
        maps = maps.bfloat16()
    before = (ps.LAUNCHES, ps.PACKED_LAUNCHES)
    out = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7,
                                  pack_x=True)
    torch.cuda.synchronize()
    assert (ps.LAUNCHES, ps.PACKED_LAUNCHES) == (before[0], before[1] + 1)
    ref = ps._sample_patches_packed_reference(maps, si, ys, xs)
    k1 = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7)
    assert (out - ref).abs().max().item() <= 1e-5
    assert (out - k1).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_pack_x_falls_back_to_k1_on_card(cuda):
    """W = 40 (not a multiple of 16): pack_x takes K1, as the reference's
    dispatcher falls through to its plain mode."""
    maps, si, ys, xs = (t.to(cuda) for t in _problem(9, S=5, H=30, W=40,
                                                     K=80))
    before = (ps.LAUNCHES, ps.PACKED_LAUNCHES)
    ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=25.7,
                            pack_x=True)
    torch.cuda.synchronize()
    assert (ps.LAUNCHES, ps.PACKED_LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_relative_pose_on_card_matches_cpu(cuda):
    """estimate_relative_pose on the card and on the CPU, same scene and
    generator seed: the draws differ between devices, so outcomes are
    compared: both within 0.5 deg / 1 deg of the truth and of each other,
    inlier counts within 2%."""
    from sara_tpu_torch.ransac.estimators import estimate_relative_pose

    rs = np.random.RandomState(3)
    n = 600
    X = rs.uniform(-2, 2, (n, 3)) + np.array([0.0, 0.0, 6.0])
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([1.0, 0.1, 0.05])

    def proj(P):
        p = P @ K.T
        return p[:, :2] / p[:, 2:]

    u = proj(X) + rs.normal(scale=0.5, size=(n, 2))
    v = proj(X @ R.T + t) + rs.normal(scale=0.5, size=(n, 2))
    out = rs.choice(n, n // 4, replace=False)
    v[out] = rs.uniform(0, 640, (len(out), 2))
    results = []
    for dev in ("cpu", cuda):
        f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        res, Re, te = estimate_relative_pose(
            g, f(u), f(v), torch.ones(n, dtype=torch.bool, device=dev),
            f(K), f(K), num_samples=500, min_inliers=100)
        results.append((int(res.num_inliers), Re.double().cpu().numpy(),
                        te.double().cpu().numpy()))

    def rot_deg(A, B):
        c = (np.trace(A.T @ B) - 1) / 2
        return np.degrees(np.arccos(np.clip(c, -1, 1)))

    def dir_deg(x, y):
        c = abs(x @ y) / np.linalg.norm(x) / np.linalg.norm(y)
        return np.degrees(np.arccos(np.clip(c, -1, 1)))

    for n_inl, Re, te in results:
        assert rot_deg(Re, R) <= 0.5 and dir_deg(te, t) <= 1.0
    (n0, R0, t0), (n1, R1, t1) = results
    assert rot_deg(R0, R1) <= 0.5 and dir_deg(t0, t1) <= 1.0
    assert abs(n0 - n1) <= 0.02 * max(n0, n1)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    def refuse(*a):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ps, "_sample_patches_reference", refuse)
    monkeypatch.setattr(ps, "_sample_patches_packed_reference", refuse)
    maps, si, ys, xs = (t.to(cuda) for t in _problem(6, S=3, H=64, W=80,
                                                     K=7))
    for pack_x in (False, True):
        for layout in (maps, _misaligned(maps)):   # vector, general variant
            before = _counts()
            out = ps.sample_field_patches(layout, si, ys, xs,
                                          max_sample_radius=11.0,
                                          pack_x=pack_x)
            torch.cuda.synchronize()
            assert out.is_cuda
            assert _counts() == _moved(before, pack_x,
                                       layout.data_ptr() == maps.data_ptr())


@pytest.mark.cuda
def test_field_descriptors_kernel_equals_gather_on_card(cuda):
    rs = np.random.RandomState(7)
    S, H, W, K = 5, 120, 160, 300
    maps = torch.from_numpy(rs.rand(S, H, W, 36).astype(np.float32)).to(cuda)
    x, y, s, th = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rs.uniform(-3, W + 2, K), rs.uniform(-3, H + 2, K),
        rs.uniform(0, S - 1, K), rs.uniform(-3.1, 3.1, K)))
    sigmas = (1.6, 2.016, 2.54, 3.2, 4.032)
    before = ps.LAUNCHES
    a = sift.sift_descriptors_field(maps, x, y, s, th, sigmas,
                                    sampler="auto")
    assert ps.LAUNCHES == before + 1
    b = sift.sift_descriptors_field(maps, x, y, s, th, sigmas,
                                    bilinear=True, sampler="gather")
    assert (a - b).abs().max().item() <= 1e-5


def _ba_problem(device, seed=0, C=6, P=120):
    """A small float32 BA problem in numpy: cameras along x looking at a
    cloud, every point seen by every camera with 0.5 px noise, poses and
    points perturbed; camera 0 fixed and camera 1's x translation pinned."""
    from sara_tpu_torch.ba import BAProblem
    from sara_tpu_torch.core import lie

    rs = np.random.RandomState(seed)
    X = rs.uniform(-2, 2, (P, 3)) + [0, 0, 8.0]
    intr = np.array([500.0, 500.0, 320.0, 240.0])
    poses = np.zeros((C, 6))
    poses[:, 3] = np.linspace(0, 1.5, C)
    poses[:, :3] = rs.normal(scale=0.02, size=(C, 3))
    cam = np.repeat(np.arange(C), P).astype(np.int32)
    pt = np.tile(np.arange(P), C).astype(np.int32)
    R = lie.so3_exp(torch.from_numpy(poses[:, :3])).numpy()
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + poses[cam, 3:]
    uv = intr[:2] * Xc[:, :2] / Xc[:, 2:] + intr[2:]
    uv += rs.normal(scale=0.5, size=uv.shape)
    poses[1:] += rs.normal(scale=2e-3, size=(C - 1, 6))
    pf = np.zeros((C, 6), bool)
    pf[0] = True
    pf[1, 3] = True
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    t = lambda a: torch.tensor(a, device=device)                        # noqa
    return BAProblem(
        poses=f(poses), points=f(X + rs.normal(scale=0.05, size=X.shape)),
        intrinsics=f(intr), cam_idx=t(cam), pt_idx=t(pt), uv=f(uv),
        obs_mask=t(np.ones(len(cam), bool)), pose_fixed=t(pf),
        point_fixed=t(np.zeros(P, bool)))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_on_card_matches_cpu(cuda, solver):
    """float32 BA on the card against the port on the CPU: the dense path
    (bfloat16 products, float32 sums) and the CG path (atomic segment
    sums) reach the same cost within 1e-3 and poses within 5e-3."""
    from sara_tpu_torch.ba import BAOptions, bundle_adjust, bundle_adjust_cg

    opts = BAOptions(max_iters=10, solver=solver)
    run = bundle_adjust if solver == "dense" else bundle_adjust_cg
    out_c, info_c = run(_ba_problem(cuda), opts)
    out_h, info_h = run(_ba_problem("cpu"), opts)
    assert out_c.poses.is_cuda and out_c.points.is_cuda
    fc, fh = float(info_c["final_cost"]), float(info_h["final_cost"])
    assert fc < 0.5 * float(info_c["initial_cost"])
    assert abs(fc - fh) <= 1e-3 * fh
    np.testing.assert_allclose(out_c.poses.cpu().numpy(),
                               out_h.poses.numpy(), atol=5e-3)


def _keypoint_sequence(n_frames=6, n_points=300, noise=0.3, seed=0,
                       capacity=512):
    """Keypoint sets of cameras moving through a point cloud, descriptors
    naming the world points (the reference tests' sequence, in numpy)."""
    from sara_tpu_torch.core.types import Keypoints

    rs = np.random.RandomState(seed)
    X = rs.uniform(-4, 4, (n_points, 3))
    X[:, 2] = rs.uniform(8.0, 12.0 + 0.5 * n_frames, n_points)
    desc = rs.normal(size=(n_points, 128))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[800.0, 0, 512.0], [0, 800.0, 384.0], [0, 0, 1.0]])
    kps, centers = [], []
    for f in range(n_frames):
        ang = 0.35 * np.sin(0.1 * f)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([2.0 * np.sin(0.1 * f), 0.1 * f, 0.5 * f])
        Xc = (X - c) @ R.T
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < 1024)
               & (uv[:, 1] >= 0) & (uv[:, 1] < 768))
        idx = np.nonzero(vis)[0][:capacity]
        n = len(idx)
        xy = np.zeros((capacity, 2), np.float32)
        xy[:n] = uv[idx] + rs.normal(scale=noise, size=(n, 2))
        d = np.zeros((capacity, 128), np.float32)
        d[:n] = desc[idx]
        mask = np.zeros(capacity, bool)
        mask[:n] = True
        kps.append(Keypoints(
            xy=torch.from_numpy(xy), scale=torch.full((capacity,), 2.0),
            orientation=torch.zeros(capacity),
            response=torch.from_numpy(mask.astype(np.float32)),
            descriptors=torch.from_numpy(d), mask=torch.from_numpy(mask)))
        centers.append(c)
    return kps, np.asarray(centers), K


@pytest.mark.cuda
def test_process_keypoints_on_card(cuda):
    """The odometry pipeline's geometric core on the card: every frame
    accepted, ATE within the reference test's gate, the map on the host."""
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline
    from sara_tpu_torch.utils import ate_rmse

    kps, centers, K = _keypoint_sequence()
    cfg = OdometryConfig(rel_pose_samples=200, pnp_samples=200,
                         rel_pose_min_inliers=50, pnp_min_inliers=20,
                         ba_window=6)
    pipe = OdometryPipeline(K, cfg)
    assert pipe.device.type == "cuda"
    ok = [pipe.process_keypoints(kp, f) for f, kp in enumerate(kps)]
    assert all(ok)
    assert pipe._prev_keypoints.xy.is_cuda
    assert ate_rmse(pipe.trajectory(), centers) < 0.15
    assert pipe.point_cloud.num_points > 100


def _drifted_circle(n=30, seed=3):
    """tests/test_pose_graph_opt.py's drifted loop in numpy (float64
    fields): exact odometry measurements along a noisy integrated chain and
    one exact loop edge of weight 10."""
    from sara_tpu_torch.core import lie

    exp = lambda w: lie.so3_exp(torch.from_numpy(w)).numpy()    # noqa: E731
    log = lambda R: lie.so3_log(torch.from_numpy(R)).numpy()    # noqa: E731
    rs = np.random.RandomState(seed)
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / n
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        gt.append((R, -R @ (5.0 * np.array([np.sin(a), 0, 1 - np.cos(a)]))))
    rel = lambda p, q: (q[0] @ p[0].T, q[1] - q[0] @ p[0].T @ p[1])  # noqa
    noisy, edges = [gt[0]], []
    for k in range(1, n):
        R, t = rel(gt[k - 1], gt[k])
        Rn = exp(log(R) + rs.normal(scale=0.01, size=3))
        Rp, tp = noisy[-1]
        noisy.append((Rn @ Rp, Rn @ tp + t + rs.normal(scale=0.02, size=3)))
        edges.append((k - 1, k, R, t, 1.0))
    edges.append((n - 1, 0, *rel(gt[n - 1], gt[0]), 10.0))
    pack = lambda R, t: np.concatenate([log(R), t])             # noqa: E731
    return [np.stack([pack(R, t) for R, t in noisy]),
            np.asarray([e[0] for e in edges]),
            np.asarray([e[1] for e in edges]),
            np.stack([pack(e[2], e[3]) for e in edges]),
            np.asarray([e[4] for e in edges]), np.ones(len(edges), bool),
            np.asarray([True] + [False] * (n - 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_optimize_pose_graph_on_card_matches_cpu(cuda, method):
    """The pose-graph LM on the card against the CPU: float64 poses within
    1e-6 (CG's segment sums are float atomics on the card), and a float32
    run on the card that lowers the cost below 1e-3 x its start."""
    from sara_tpu_torch.convert import pose_graph_problem_from_numpy
    from sara_tpu_torch.sfm.pose_graph_opt import optimize_pose_graph

    fields = _drifted_circle()
    kw = dict(max_iters=30, method=method, cg_iters=100)
    out_c, info_c = optimize_pose_graph(
        pose_graph_problem_from_numpy(fields, cuda), **kw)
    out_h, info_h = optimize_pose_graph(
        pose_graph_problem_from_numpy(fields, "cpu"), **kw)
    assert out_c.poses.is_cuda
    np.testing.assert_allclose(out_c.poses.cpu().numpy(), out_h.poses.numpy(),
                               atol=1e-6)
    p32 = pose_graph_problem_from_numpy(fields, cuda, torch.float32)
    _, info32 = optimize_pose_graph(p32, **kw)
    assert float(info32["final_cost"]) < 1e-3 * float(info32["initial_cost"])


@pytest.mark.cuda
def test_average_rotations_on_card_matches_cpu(cuda):
    """Rotation averaging of a 16-view graph with 15% outlier edges on the
    card against the CPU: chordal distance <= 1e-6 in float64 (cuSOLVER's
    QR may pick other column signs; the gauge removal is invariant), <=
    1e-4 between the card's float32 and float64 runs."""
    from sara_tpu_torch.core import lie
    from sara_tpu_torch.sfm.rotation_averaging import average_rotations

    rs = np.random.RandomState(2)
    n = 16
    Rw = [lie.so3_exp(torch.tensor([0.0, 2 * np.pi * k / n, 0.0],
                                   dtype=torch.float64)).numpy()
          for k in range(n)]
    ei, ej, Rr = [], [], []
    for k in range(n):
        for d in (1, 2, 3):
            j = (k + d) % n
            ei.append(k), ej.append(j), Rr.append(Rw[j] @ Rw[k].T)
    for b in rs.choice(len(Rr), len(Rr) * 15 // 100, replace=False):
        Rr[b] = lie.so3_exp(torch.from_numpy(rs.normal(size=3))).numpy()
    args = [torch.tensor(ei), torch.tensor(ej), torch.from_numpy(np.stack(Rr))]
    R_h = average_rotations(n, *args)
    R_c = average_rotations(n, *(a.to(cuda) for a in args))
    R_32 = average_rotations(n, *(a.to(cuda) for a in args[:2]),
                             args[2].to(cuda).float())
    assert R_c.is_cuda and R_32.dtype == torch.float32
    dist = lambda A, B: (A - B).flatten(1).norm(dim=1).max().item()  # noqa
    assert dist(R_c.cpu(), R_h) <= 1e-6
    assert dist(R_32.double().cpu(), R_h) <= 1e-4


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """save_sfm_state / load_sfm_state of a pipeline on the card: the
    restored pipeline holds the same trajectory, map and generator state,
    its keypoints on the card, and goes on accepting frames."""
    from sara_tpu_torch.io import load_sfm_state, save_sfm_state
    from sara_tpu_torch.sfm import OdometryConfig, OdometryPipeline

    kps, _, K = _keypoint_sequence()
    cfg = OdometryConfig(rel_pose_samples=200, pnp_samples=200,
                         rel_pose_min_inliers=50, pnp_min_inliers=20,
                         ba_window=6)
    pipe = OdometryPipeline(K, cfg)
    assert all(pipe.process_keypoints(kp, f) for f, kp in enumerate(kps[:4]))
    path = str(tmp_path / "state.npz")
    save_sfm_state(path, pipe)
    back = load_sfm_state(path, OdometryPipeline(K, cfg))
    np.testing.assert_array_equal(back.trajectory(), pipe.trajectory())
    np.testing.assert_array_equal(back.point_cloud.points,
                                  pipe.point_cloud.points)
    assert torch.equal(back._gen.get_state(), pipe._gen.get_state())
    for a, b in zip(back._prev_keypoints, pipe._prev_keypoints):
        assert a.is_cuda and torch.equal(a, b)
    assert all(back.process_keypoints(kp, f)
               for f, kp in enumerate(kps[4:], start=4))


@pytest.mark.cuda
def test_run_global_sfm_on_card(cuda):
    """The global pipeline on the card, chunks of 8 pairs over 6 views of
    the reference tests' sequence: the reference test's gates."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse

    kps, centers_gt, K = _keypoint_sequence()
    cfg = GlobalSfMConfig(rel_pose_samples=200, min_pair_inliers=30,
                          pair_chunk=8, ba_options=BAOptions(max_iters=20))
    out = run_global_sfm(kps, K, config=cfg)
    assert out["ba_problem"].poses.is_cuda
    V = len(kps)
    centers = np.stack([-out["R"][v].T @ out["t"][v] for v in range(V)])
    assert out["num_edges"] >= V - 1
    assert ate_rmse(centers, centers_gt) < 0.15
    assert len(out["points"]) > 100
    assert out["ba_info"]["final_cost"] < out["ba_info"]["initial_cost"]


@pytest.mark.cuda
def test_run_global_sfm_partitioned_on_card(cuda):
    """The global pipeline with the partitioned BA (2 blocks, 2 sweeps) on
    a "block" mesh of one rank on the card: the reference test's gates."""
    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.parallel import make_mesh
    from sara_tpu_torch.sfm.global_sfm import GlobalSfMConfig, run_global_sfm
    from sara_tpu_torch.utils import ate_rmse

    kps, centers_gt, K = _keypoint_sequence()
    cfg = GlobalSfMConfig(rel_pose_samples=200, min_pair_inliers=30,
                          pair_chunk=8, ba_options=BAOptions(max_iters=10),
                          ba_blocks=2, ba_sweeps=2)
    out = run_global_sfm(kps, K, config=cfg, ba_mesh=make_mesh(axis="block"))
    V = len(kps)
    centers = np.stack([-out["R"][v].T @ out["t"][v] for v in range(V)])
    assert ate_rmse(centers, centers_gt) < 0.15
    assert len(out["points"]) > 100
    assert out["ba_info"]["final_cost"] <= out["ba_info"]["initial_cost"]


@pytest.mark.cuda
def test_sharded_dense_schur_nccl_world_of_one(cuda):
    """dense_schur_bundle_adjust_sharded on a world of one under NCCL (one
    H100 takes one rank) equals the unsharded loop on the same packing."""
    import torch.distributed as dist

    from sara_tpu_torch.ba import BAOptions
    from sara_tpu_torch.ba.dense_schur import (
        dense_schur_bundle_adjust, dense_schur_bundle_adjust_sharded,
        pack_pt_major)
    from sara_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert dist.get_backend() == "nccl" and mesh.size() == 1
    prob = _ba_problem(cuda)
    opts = BAOptions(max_iters=8)
    ptm, stats = pack_pt_major(prob, chunk=64)
    _, _, ref = dense_schur_bundle_adjust(ptm, opts, stats["chunk"])
    poses, points, info = dense_schur_bundle_adjust_sharded(
        ptm, mesh, opts, stats["chunk"])
    assert poses.is_cuda and points.shape[0] == ptm.points.shape[0]
    rel = ((info["costs"] - ref["costs"]).abs() / ref["costs"]).max()
    assert float(rel) <= 1e-6
    assert float(info["final_cost"]) < float(info["initial_cost"])


@pytest.mark.cuda
def test_partitioned_on_card_matches_cpu(cuda):
    """The partitioned BA (blocks batched by vmap) in float32 on the card
    against the CPU: final costs within 1e-3 relative."""
    from sara_tpu_torch.ba import BAOptions, ba_cost
    from sara_tpu_torch.ba.partitioned import partitioned_bundle_adjust

    costs = []
    for dev in (cuda, torch.device("cpu")):
        prob = _ba_problem(dev)
        out, info = partitioned_bundle_adjust(prob, 2, BAOptions(max_iters=6),
                                              sweeps=2)
        assert out.poses.device.type == dev.type
        costs.append(float(ba_cost(out, 4.0, 6.0)))
        assert costs[-1] < float(ba_cost(prob, 4.0, 6.0))
    assert abs(costs[0] - costs[1]) <= 1e-3 * costs[1]


@pytest.mark.cuda
def test_batched_pair_chunk_on_card_matches_cpu(cuda, monkeypatch):
    """The chunked pair stage as one batched program on the card against
    the same program on the CPU, with the same sample indices: the same
    matches and success, rotations within 1e-3."""
    from sara_tpu_torch.ransac import engine
    from sara_tpu_torch.sfm.global_sfm import _pair_chunk_program

    kps, _, K = _keypoint_sequence()
    draw = engine.draw_samples

    def same_samples(gen, S, k, mask):
        idx, ok = draw(torch.Generator().manual_seed(0), S, k, mask.cpu())
        return idx.to(mask.device), ok.to(mask.device)

    monkeypatch.setattr(engine, "draw_samples", same_samples)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        stack = lambda n: torch.stack([getattr(k, n).to(dev)  # noqa: E731
                                       for k in kps])
        outs.append(_pair_chunk_program(
            stack("xy"), stack("descriptors"), stack("mask"),
            [0, 1, 2, None], [1, 2, 3, None], None,
            torch.tensor(K, dtype=torch.float32, device=dev), 0.8, 4.0, 200,
            30))
    (j, ok, inl, success, R, t), ref = outs[0], outs[1]
    assert R.is_cuda
    assert torch.equal(ok.cpu(), ref[1]) and torch.equal(success.cpu(),
                                                         ref[3])
    assert success.tolist() == [True, True, True, False]
    assert float((R.cpu() - ref[4])[:3].abs().max()) < 1e-3


def _calib_view(device):
    """One 720p view of the 6x9 board of chip_smoke's phase "calib"."""
    import chip_smoke as cs

    R, t = cs.board_pose(np.radians(20.0), np.radians(-15.0), 6, 9, 14.0)
    return cs.render_chessboard(cs.CALIB_K, R, t, 6, 9, hw=cs.CALIB_HW,
                                ss=6, device=device)


@pytest.mark.cuda
def test_corner_candidates_on_card_match_cpu(cuda):
    """Slice E's device program (Harris, lexicographic NMS, top-k, the two
    subpixel refinements, the x-corner test) on the card against the CPU:
    the same masked candidates within 1e-3 px."""
    from sara_tpu_torch.calib import chessboard as cb

    img = _calib_view(cuda)[0]
    p = cb.ChessboardParams()
    oc = cb._corner_candidates(torch.from_numpy(img), p)
    og = cb._corner_candidates(torch.from_numpy(img).to(cuda), p)
    pts = []
    for o in (oc, og):
        m = o["mask"].cpu().numpy()
        pts.append(np.stack([o["x"].cpu().numpy()[m],
                             o["y"].cpu().numpy()[m]], axis=1))
    assert len(pts[0]) == len(pts[1]) >= 54
    d = np.linalg.norm(pts[0][:, None] - pts[1][None], axis=-1)
    assert d.min(1).max() <= 1e-3 and d.min(0).max() <= 1e-3


@pytest.mark.cuda
def test_calibrate_pinhole_on_card_matches_cpu(cuda):
    """The LM on the card against the CPU in float64 (1e-6 relative on K),
    and the card's float32 run against its float64 run (1e-3 relative)."""
    import chip_smoke as cs
    from sara_tpu_torch.calib import cli

    corners = []
    for img, pix in cs.calib_views(6, device=cuda):
        corners.append(pix.reshape(-1, 2) + np.random.RandomState(
            len(corners)).normal(scale=0.1, size=(54, 2)))
    r_cpu = cli.calibrate_views(corners, 6, 9, device="cpu")
    r_gpu = cli.calibrate_views(corners, 6, 9, device=cuda)
    r_32 = cli.calibrate_views([c.astype(np.float32) for c in corners], 6, 9,
                               device=cuda)
    np.testing.assert_allclose(r_gpu["K"], r_cpu["K"], rtol=1e-6)
    assert abs(r_gpu["rms"] - r_cpu["rms"]) < 1e-6
    np.testing.assert_allclose(r_32["K"], r_gpu["K"], rtol=1e-3)
    assert abs(r_gpu["K"][0, 0] - 1000.0) < 5


@pytest.mark.cuda
def test_hough_lines_on_card_equal_cpu(cuda):
    """``hough_lines`` on the card returns the CPU's lines bit for bit
    (rho, theta, votes, in order) on the Canny edges of a 240x320 view of
    phase "calib"'s board and on dense random edges: the votes are
    integers below 2^24, so the card's atomics are exact, and every
    rounding and the tie order are pinned (``image/edges.py``)."""
    from sara_tpu_torch.image import edges

    cs = _chip_smoke()
    K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1.0]])
    R, t = cs.board_pose(np.radians(20.0), np.radians(-15.0), 6, 9, 14.0)
    img = cs.render_chessboard(K, R, t, 6, 9, hw=(240, 320))[0]
    board = edges.canny(torch.from_numpy(img))
    dense = torch.from_numpy(np.random.RandomState(0).rand(240, 320) < 0.3)
    for e, k in ((board, 64), (dense, 4096)):
        cpu = edges.hough_lines(e, max_lines=k)
        card = edges.hough_lines(e.to(cuda), max_lines=k)
        for a, b in zip(cpu, card):
            assert b.device.type == "cuda" and torch.equal(b.cpu(), a)
    assert float(cpu[2][0]) > 0


@pytest.mark.cuda
def test_darknet_forward_and_nms_on_card_match_cpu(cuda, tmp_path):
    """yolov4-tiny (the repository's copy of the published architecture)
    at 160x160 on a batch of 2, with the batch-norm statistics off the
    identity: every layer on the card against the CPU within the JAX
    package's tolerance (atol 2e-3, rtol 1e-3), and NMS on the card
    picking the CPU's boxes from the same decoded heads."""
    from darknet_cfgs import perturb_batch_norm, write_cfg
    from sara_tpu_torch.nn import (darknet_forward, init_darknet_params,
                                   nms_boxes, parse_darknet_cfg, yolo_decode)

    cfg = parse_darknet_cfg(write_cfg(tmp_path))
    host, _ = init_darknet_params(cfg, seed=3, device="cpu")
    host = perturb_batch_norm(host, 2)
    x = np.random.RandomState(0).rand(2, 160, 160, 3).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        params = [None if p is None else
                  {k: torch.as_tensor(v).to(dev) for k, v in p.items()}
                  for p in host]
        outs.append(darknet_forward(params, cfg, torch.from_numpy(x).to(dev)))
    (cy, co), (gy, go) = outs
    assert len(co) == len(go) == len(cfg) - 1
    for a, b in zip(co, go):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=2e-3,
                                   rtol=1e-3)
    for (_, f, sec) in gy:
        dec = yolo_decode(f[1:2], sec, 160, 160)
        idx, keep = nms_boxes(dec["boxes"], dec["score"], dec["mask"])
        cidx, ckeep = nms_boxes(*(dec[k].cpu() for k in ("boxes", "score",
                                                         "mask")))
        assert torch.equal(keep.cpu(), ckeep) and keep.any()
        assert torch.equal(idx.cpu()[ckeep], cidx[ckeep])


@pytest.mark.cuda
def test_tracker_on_card_matches_cpu(cuda):
    """chip_smoke's 40-lane stream (100 frames) through the tracker on the
    card and on the CPU: the same IDs every frame, boxes within 1e-3 px,
    at most two device reads per step."""
    import chip_smoke as cs

    frames, _ = cs.track_stream(n_frames=100)
    boxes = [f[0] for f in frames]
    gpu, _, mot = cs.run_tracker(cuda, boxes)
    cpu, _, _ = cs.run_tracker("cpu", boxes)
    ok, worst = cs.same_tracks(gpu, cpu)
    assert ok, worst
    assert mot.syncs <= 2 * len(boxes)
    assert sum(len(o) for o in gpu) > 1000


@pytest.mark.cuda
def test_propagation_on_card_matches_cpu(cuda):
    """Match propagation on a similarity-warped scene of 1,024 match slots
    (700 inliers, 200 outliers): the consistency matrix, members, labels
    and densified mask on the card equal the CPU's."""
    from sara_tpu_torch.core.types import Keypoints, Matches
    from sara_tpu_torch.matching import (match_consistency_matrix,
                                         propagate_matches)

    rs = np.random.RandomState(0)
    cap, n_in, n_out = 1024, 700, 200
    th, s = 0.3, 1.2
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    xa = rs.uniform(0, 600, (n_in + n_out, 2))
    xb = s * xa @ R.T + [30.0, -12.0]
    xb[n_in:] = rs.uniform(0, 600, (n_out, 2))
    n = n_in + n_out

    def kp(xy, rot, scale):
        pad = lambda a: np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1))
        return dict(xy=pad(xy).astype(np.float32),
                    scale=np.full(cap, 5.0 * scale, np.float32),
                    orientation=np.full(cap, rot, np.float32),
                    response=np.zeros(cap, np.float32),
                    descriptors=np.zeros((cap, 4), np.float32),
                    mask=np.arange(cap) < n)

    idx = np.pad(np.arange(n), (0, cap - n)).astype(np.int32)
    m = dict(i=idx, j=idx.copy(),
             score=np.pad(rs.permutation(n) / n + 0.1,
                          (0, cap - n)).astype(np.float32),
             mask=np.arange(cap) < n)
    res = []
    for dev in ("cpu", cuda):
        on = lambda d: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
        ka, kb = Keypoints(**on(kp(xa, 0.0, 1.0))), Keypoints(
            **on(kp(xb, th, s)))
        mm = Matches(**on(m))
        res.append((match_consistency_matrix(ka, kb, mm),
                    *propagate_matches(ka, kb, mm, num_seeds=32)))
    for a, b in zip(*res):
        assert torch.equal(b.cpu(), a)
    assert res[0][3].sum() > 400


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_e3_on_card_matches_cpu(cuda):
    """The E3 functions (Deriche, Otsu, adaptive threshold, CCL, watershed,
    SLIC, gemm_conv2d, signed distance, the narrow band, border following)
    on the card against the CPU on the same inputs, at 120x160: phase
    "e3"'s gates."""
    cs = _chip_smoke()
    out = cs.phase_e3(ps, "card test", device=cuda, hw=(120, 160))
    assert out["functions"]["narrow_band_flow"]["band_reads"] == 50


@pytest.mark.cuda
def test_demo_twins_on_card(cuda):
    """The six demo twins on the card (no ``--cpu``) at 240 px wide, 6 VO
    frames and 4 SfM views: phase "demos"'s gates."""
    cs = _chip_smoke()
    out = cs.phase_demos(ps, "card test", device=cuda, width=240,
                         vo_frames=6, sfm_views=4)
    assert set(out) >= set(cs.DEMOS)


@pytest.mark.cuda
def test_bench_twin_counts_on_card_match_cpu(cuda, monkeypatch):
    """The bench twin's ``bench_ours`` on the noise pair at 240x320 (its
    capacity 8192, two pipelined pairs): the card's keypoint and match
    counts, warm-up and pipelined, within 1% of the CPU's."""
    _chip_smoke()
    import torch_bench as tb

    monkeypatch.setattr(tb, "ITERS", 2)
    a, b = tb.load_pair(240, 320)
    seen = {}
    for dev in (cuda, "cpu"):
        tb.bench_ours(a, b, device=dev, record=seen.setdefault(str(dev), {}))
    card, cpu = seen["cuda"], seen["cpu"]
    for got, want in ((card["keypoints"], cpu["keypoints"]),
                      ([card["matches"]] + card["pipelined_counts"],
                       [cpu["matches"]] + cpu["pipelined_counts"])):
        np.testing.assert_allclose(got, want, rtol=0.01)
    assert cpu["matches"] > 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_folded_field_equals_per_frame_on_card(cuda, dtype):
    """K1 on a batch's frame-folded (B·S, H, W, C) field with ``s_idx +
    b·S``: one launch whose rows equal each frame's own launch and the
    plain version within 1e-6."""
    rs = np.random.RandomState(11)
    B, S, H, W, K = 4, 5, 120, 160, 257
    maps = torch.from_numpy(rs.rand(B, S, H, W, 36).astype(np.float32)).to(
        cuda, dtype)
    s_idx = torch.from_numpy(rs.randint(0, S, (B, K))).to(cuda)
    ys = torch.from_numpy(rs.uniform(-2, H + 1, (B, K, 16))
                          .astype(np.float32)).to(cuda)
    xs = torch.from_numpy(rs.uniform(-2, W + 1, (B, K, 16))
                          .astype(np.float32)).to(cuda)
    fold = (s_idx + S * torch.arange(B, device=cuda)[:, None]).reshape(-1)
    args = (maps.reshape(B * S, H, W, 36), fold, ys.reshape(-1, 16),
            xs.reshape(-1, 16))
    before = ps.LAUNCHES
    folded = ps.sample_field_patches(*args, max_sample_radius=20.0)
    assert ps.LAUNCHES == before + 1
    plain = ps._sample_patches_reference(*args)
    assert (folded - plain).abs().max().item() <= 1e-6
    for b in range(B):
        one = ps.sample_field_patches(maps[b], s_idx[b], ys[b], xs[b],
                                      max_sample_radius=20.0)
        assert (folded[b * K:(b + 1) * K] - one).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_batch_frontend_on_card_against_per_frame(cuda):
    """``_compute_sift_batch`` of three room frames at 240x320 with the
    kernel sampler: one K1 launch per octave for the whole batch; each
    frame's keypoints overlap (0.5 px, 1% in scale) >= 98% of the same
    frame's ``compute_sift_keypoints`` on the card (cuDNN may round a
    batch's blurs unlike one frame's) and of the batch on the CPU."""
    import dataclasses

    cs = _chip_smoke()
    from sara_tpu_torch.features.api import (SIFTParams, _compute_sift_batch,
                                             compute_sift_keypoints)
    from sara_tpu_torch.image.pyramid import gaussian_pyramid

    _, imgs, _ = cs.vo_frames(3, hw=(240, 320))
    stack = np.stack(imgs).astype(np.float32)
    params = dataclasses.replace(SIFTParams(), desc_sampler="kernel",
                                 desc_sample_nearest=False)
    before = ps.LAUNCHES
    kb = _compute_sift_batch(stack, params, device=cuda)
    n_oct = len(gaussian_pyramid(torch.zeros(240, 320),
                                 params.pyramid).octaves)
    assert ps.LAUNCHES == before + n_oct
    cpu = _compute_sift_batch(stack, dataclasses.replace(
        params, desc_sampler="gather"), device="cpu")
    for b in range(3):
        one = compute_sift_keypoints(stack[b], params, device=cuda)
        for other in (one, type(one)(*(f[b] for f in cpu))):
            m, mo = kb.mask[b].cpu(), other.mask.cpu()
            assert cs.kp_overlap(kb.xy[b].cpu()[m], kb.scale[b].cpu()[m],
                                 other.xy.cpu()[mo],
                                 other.scale.cpu()[mo]) >= 0.98
            assert abs(int(m.sum()) - int(mo.sum())) <= 0.02 * int(mo.sum())
