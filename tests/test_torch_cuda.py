"""Card-only tests of the port's CUDA kernels and of Slice B's estimators
on the card (marker ``cuda``).

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
