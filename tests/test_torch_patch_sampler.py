"""Port parity: the patch sampler (kernels K1 and K2) and its wrapper.

On the CPU the port's ``sample_field_patches`` takes the plain version of
the kernel it would launch; it is held to the JAX package's Pallas kernel
run in interpret mode (as ``tests/test_patch_sampler.py`` runs it) at 1e-5
absolute, on the same cases, in the plain mode (K1) and the x-packed mode
(K2, ``pack_x=True``). The CUDA kernels themselves are held to their plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.ops.patch_sampler import \
    sample_field_patches as jax_sample_field_patches
from sara_tpu_torch.ops import _build
from sara_tpu_torch.ops import patch_sampler as ps


def _random_problem(rs, S=3, H=64, W=80, C=36, K=24, N=16, rad=5.0,
                    edge=False):
    maps = rs.rand(S, H, W, C).astype(np.float32)
    if edge:
        cy = rs.choice([0.0, 1.0, H - 2.0, H - 1.0], K)
        cx = rs.choice([0.0, 1.0, W - 2.0, W - 1.0], K)
    else:
        cy = rs.uniform(0, H - 1, K)
        cx = rs.uniform(0, W - 1, K)
    ys = (cy[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    xs = (cx[:, None] + rs.uniform(-rad, rad, (K, N))).astype(np.float32)
    si = rs.randint(0, S, K).astype(np.int32)
    return maps, si, ys, xs


def _numpy_bilinear(maps, si, ys, xs):
    """Loop reference: clamp, then the four taps of each sample."""
    S, H, W, C = maps.shape
    out = np.zeros(ys.shape + (C,), np.float64)
    for k in range(ys.shape[0]):
        for n in range(ys.shape[1]):
            y = min(max(float(ys[k, n]), 0.0), H - 1.0)
            x = min(max(float(xs[k, n]), 0.0), W - 1.0)
            y0, x0 = int(np.floor(y)), int(np.floor(x))
            y1, x1 = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
            fy, fx = y - y0, x - x0
            m = maps[si[k]].astype(np.float64)
            out[k, n] = (m[y0, x0] * (1 - fx) * (1 - fy)
                         + m[y0, x1] * fx * (1 - fy)
                         + m[y1, x0] * (1 - fx) * fy + m[y1, x1] * fx * fy)
    return out


def _port(maps, si, ys, xs, device="cpu", **kw):
    t = [torch.from_numpy(a).to(device) for a in (maps, si, ys, xs)]
    return ps.sample_field_patches(*t, max_sample_radius=11.0, **kw)


@pytest.mark.parametrize("case", ["random", "edge", "k13"])
def test_matches_pallas_interpret(case):
    rs = np.random.RandomState({"random": 3, "edge": 4, "k13": 7}[case])
    kw = {"edge": case == "edge"}
    if case == "k13":
        kw["K"] = 13
    maps, si, ys, xs = _random_problem(rs, **kw)
    ref = jax_sample_field_patches(jnp.asarray(maps), jnp.asarray(si),
                                   jnp.asarray(ys), jnp.asarray(xs),
                                   max_sample_radius=11.0, block=8,
                                   interpret=True)
    assert ref is not None
    out = _port(maps, si, ys, xs)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_geometry_the_jax_dispatcher_declines():
    """The port samples every geometry; JAX returns None here."""
    rs = np.random.RandomState(1)
    maps, si, ys, xs = _random_problem(rs, H=16, W=16, K=9, rad=30.0)
    assert jax_sample_field_patches(jnp.asarray(maps), jnp.asarray(si),
                                    jnp.asarray(ys), jnp.asarray(xs),
                                    max_sample_radius=40.0,
                                    interpret=True) is None
    np.testing.assert_allclose(_port(maps, si, ys, xs).numpy(),
                               _numpy_bilinear(maps, si, ys, xs),
                               atol=1e-5, rtol=0)


def test_bf16_maps_accumulate_in_f32():
    rs = np.random.RandomState(2)
    maps, si, ys, xs = _random_problem(rs, K=5)
    t = [torch.from_numpy(a) for a in (maps, si, ys, xs)]
    out = ps.sample_field_patches(t[0].bfloat16(), *t[1:],
                                  max_sample_radius=11.0)
    assert out.dtype == torch.float32
    ref = _numpy_bilinear(t[0].bfloat16().float().numpy(), si, ys, xs)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["random", "edge", "k13"])
def test_packed_matches_pallas_interpret(case):
    """K2's plain version against the JAX package's x-packed kernel."""
    rs = np.random.RandomState({"random": 13, "edge": 14, "k13": 17}[case])
    kw = {"edge": case == "edge"}
    if case == "k13":
        kw["K"] = 13
    maps, si, ys, xs = _random_problem(rs, **kw)          # W = 80
    ref = jax_sample_field_patches(jnp.asarray(maps), jnp.asarray(si),
                                   jnp.asarray(ys), jnp.asarray(xs),
                                   max_sample_radius=11.0, block=8,
                                   pack_x=True, interpret=True)
    assert ref is not None
    out = _port(maps, si, ys, xs, pack_x=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("W,C,packed", [(80, 36, True), (1280, 36, True),
                                        (40, 36, False), (72, 36, False),
                                        (80, 72, False)])
def test_pack_x_dispatch_rule(monkeypatch, W, C, packed):
    """pack_x takes K2 where 2C <= 128 and W % 16 == 0 (the reference's
    rule), else K1; either way the samples are the same function."""
    assert ps.packed_layout_ok((1, 8, W, C)) is packed
    calls = []
    for name in ("_sample_patches_reference",
                 "_sample_patches_packed_reference"):
        fn = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    rs = np.random.RandomState(W + C)
    maps, si, ys, xs = _random_problem(rs, H=8, W=W, C=C, K=5, rad=3.0)
    out = _port(maps, si, ys, xs, pack_x=True)
    assert calls == ["_sample_patches_packed_reference" if packed
                     else "_sample_patches_reference"]
    np.testing.assert_allclose(out.numpy(), _numpy_bilinear(maps, si, ys, xs),
                               atol=1e-5, rtol=0)


def test_pack_x_bf16_and_edge_columns():
    """x at the last column (odd, so the cell past the row is clamped with
    weight 0) and bf16 maps: K2's plain version equals K1's."""
    rs = np.random.RandomState(8)
    maps, si, ys, xs = (torch.from_numpy(a) for a in
                        _random_problem(rs, H=16, W=32, K=6, rad=2.0))
    xs[:, 0] = 31.0
    xs[:, 1] = 1e6
    xs[:, 2] = -3.0
    maps = maps.bfloat16()
    a = ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=3.0,
                                pack_x=True)
    b = ps._sample_patches_reference(maps, si, ys, xs)
    assert a.dtype == torch.float32
    assert (a - b).abs().max().item() <= 1e-5


def test_tpu_window_fits_copies_the_reference_rule():
    """The port's copy of the reference's fit rule decides as the JAX
    dispatcher does (None exactly where it returns False)."""
    rs = np.random.RandomState(9)
    for H, W, rad in ((24, 24, 15.9), (64, 80, 11.0), (64, 76, 11.0),
                      (40, 48, 5.0), (16, 16, 40.0), (200, 200, 30.0)):
        maps, si, ys, xs = _random_problem(rs, H=H, W=W, K=2, rad=1.0)
        fits = ps.tpu_window_fits(maps.shape, 4, rad)
        got = jax_sample_field_patches(jnp.asarray(maps), jnp.asarray(si),
                                       jnp.asarray(ys), jnp.asarray(xs),
                                       max_sample_radius=rad, interpret=True)
        assert fits is (got is not None), (H, W, rad)
    assert ps.patch_extent(13.0) == 32 and ps.patch_extent(100.0) == -1


@pytest.mark.parametrize("bad", ["float_idx", "f64_coords",
                                 "shape", "f16_maps", "meta"])
def test_wrapper_rejects(bad):
    rs = np.random.RandomState(0)
    maps, si, ys, xs = (torch.from_numpy(a) for a in
                        _random_problem(rs, K=4))
    kw = {}
    if bad == "float_idx":
        si = si.float()
    elif bad == "f64_coords":
        ys = ys.double()
    elif bad == "shape":
        xs = xs[:, :8]
    elif bad == "f16_maps":
        maps = maps.half()
    else:
        maps, si, ys, xs = (t.to("meta") for t in (maps, si, ys, xs))
    before = ps.counts()
    with pytest.raises(ValueError):
        ps.sample_field_patches(maps, si, ys, xs, max_sample_radius=11.0,
                                **kw)
    assert ps.counts() == before


def test_cpu_path_counts_no_launch():
    rs = np.random.RandomState(0)
    before = ps.counts()
    for pack_x in (False, True):
        _port(*_random_problem(rs, K=3), pack_x=pack_x)
    assert ps.counts() == before


def _at_offset(shape, dtype, offset):
    """A contiguous (S, H, W, C) view starting ``offset`` elements into a
    fresh (aligned) buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("C,dtype,offset,ok", [
    (36, torch.float32, 0, True),      # the descriptor field
    (36, torch.bfloat16, 0, True),
    (4, torch.float32, 0, True),
    (1024, torch.float32, 0, True),
    (37, torch.float32, 0, False),     # C % 4 != 0
    (34, torch.float32, 0, False),     # even, but not a multiple of 4
    (2, torch.float32, 0, False),
    (1028, torch.float32, 0, False),   # a team of C/4 lanes exceeds a block
    (36, torch.float32, 1, False),     # base 4 B past a 16-B boundary
    (36, torch.float32, 2, False),
    (36, torch.float32, 4, True),      # 16 B: aligned again
    (36, torch.bfloat16, 1, False),    # 2 B past an 8-B boundary
    (36, torch.bfloat16, 4, True),     # 8 B
], ids=lambda v: str(v).replace("torch.", ""))
def test_vector_layout_ok(C, dtype, offset, ok):
    """The vector variant takes C % 4 == 0 (C <= 1024) at a base aligned
    for 16-byte (float32) or 8-byte (bfloat16) loads; the rest goes to the
    general variant."""
    maps = _at_offset((2, 4, 8, C), dtype, offset)
    assert maps.is_contiguous()
    assert ps.vector_layout_ok(maps) is ok


@pytest.mark.parametrize("index,copied", [
    ("int64", False), ("int32", False), ("int16", True),
    ("int64_strided", True)])
@pytest.mark.parametrize("pack_x", [False, True])
def test_card_side_reads_the_index_in_place(monkeypatch, index, copied,
                                            pack_x):
    """The wrapper's card side hands int32 and int64 indices to the kernel
    as they are (the frontend's int64 costs no conversion launch); it copies
    only other integer types or a strided index, and counts the copy."""
    rs = np.random.RandomState(5)
    maps, si, ys, xs = (torch.from_numpy(a) for a in
                        _random_problem(rs, K=6))
    dtype = getattr(torch, index.split("_")[0])
    si = si.to(dtype)
    if index.endswith("strided"):
        si = torch.stack([si, si], 1)[:, 0]
    seen = []
    monkeypatch.setattr(ps, "_launch", lambda m, s, y, x, packed, vector:
                        seen.append((s, packed, vector)))
    copies = ps.INDEX_COPIES
    ps._sample_on_card(maps, si, ys, xs, pack_x)
    (s, packed, vector), = seen
    assert (packed, vector) == (pack_x, True)
    assert s.is_contiguous() and s.dtype in (torch.int32, torch.int64)
    assert (s.data_ptr() != si.data_ptr()) is copied
    assert s.dtype == (torch.int32 if copied else dtype)
    assert ps.INDEX_COPIES == copies + copied
    assert torch.equal(s.long(), si.long())


def test_card_side_takes_the_general_variant_where_vectors_cannot_read(
        monkeypatch):
    seen = []
    rs = np.random.RandomState(6)
    _, si, ys, xs = (torch.from_numpy(a) for a in _random_problem(rs, K=4))
    monkeypatch.setattr(ps, "_launch", lambda m, s, y, x, packed, vector:
                        seen.append(vector))
    for maps in (_at_offset((3, 64, 80, 36), torch.float32, 1),
                 _at_offset((3, 64, 80, 37), torch.float32, 0),
                 _at_offset((3, 64, 80, 36), torch.float32, 0)):
        ps._sample_on_card(maps, si, ys, xs, False)
    assert seen == [False, False, True]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise and leaves no library."""
    import sys

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)
    with pytest.raises(RuntimeError, match="patch_sampler.cu"):
        _build.build("patch_sampler")
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("bad", ["strided_maps", "too_many_pixels"])
def test_card_side_rejects(bad):
    rs = np.random.RandomState(0)
    maps, si, ys, xs = (torch.from_numpy(a) for a in
                        _random_problem(rs, K=4))
    if bad == "strided_maps":
        maps = torch.zeros(3, 64, 80, 37)[..., 1:]
    else:
        maps = torch.empty((2 ** 16, 2 ** 8, 2 ** 7, 36), device="meta")
    before = ps.counts()
    with pytest.raises(ValueError):
        ps._sample_on_card(maps, si, ys, xs, False)
    assert ps.counts() == before


def test_library_name_tracks_source_and_flags():
    assert _build.kernel_names() == ["patch_sampler"]
    assert _build.library_path("patch_sampler").suffix == ".so"
    assert _build.library_path("patch_sampler").parent == _build.BUILD_DIR
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
