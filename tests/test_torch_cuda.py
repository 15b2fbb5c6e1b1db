"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

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


def _problem(seed, S, H, W, K, N=16, C=36, rad=20.0, edge=False):
    rs = np.random.RandomState(seed)
    maps = rs.rand(S, H, W, C).astype(np.float32)
    pins = lambda n: rs.choice([0.0, 1.0, n - 2.0, n - 1.0], K)
    cy = pins(H) if edge else rs.uniform(0, H - 1, K)
    cx = pins(W) if edge else rs.uniform(0, W - 1, K)
    ys = (cy[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    xs = (cx[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    si = rs.randint(0, S, K).astype(np.int32)
    return [torch.from_numpy(a) for a in (maps, si, ys, xs)]


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
def test_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    def refuse(*a):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ps, "_sample_patches_reference", refuse)
    out = ps.sample_field_patches(
        *(t.to(cuda) for t in _problem(6, S=3, H=64, W=80, K=7)),
        max_sample_radius=11.0)
    torch.cuda.synchronize()
    assert out.is_cuda


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
