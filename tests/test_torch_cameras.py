"""Port parity: camera models (``core/cameras.py``), the dense warps of
``image/transform.py`` and ``image/color.py`` against their ``sara_tpu``
twins.

Inputs are seeded numpy arrays cast to float32 on both sides (the suite's
conftest turns on JAX x64). The camera constructors build float32 tensors
on both sides. Projections are held to 1e-3 pixels (float32 pixels of a
few hundred, a few ulps), rays and the 10-step iterations to 1e-6 in
normalized units, the undistortion maps to 1e-3 pixels, the warps to 1e-5
and the gray conversion to 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core import cameras as jcam
from sara_tpu.image import color as jcolor
from sara_tpu.image import transform as jtf
from sara_tpu_torch.core import cameras as tcam
from sara_tpu_torch.image import color as tcolor
from sara_tpu_torch.image import transform as ttf

K_VALUES = dict(fx=410.0, fy=405.0, u0=161.5, v0=118.0, s=0.7)


def f32(a):
    return np.asarray(a, np.float32)


def J(a):
    return jnp.asarray(f32(a))


def T(a):
    return torch.from_numpy(f32(a).copy())


def close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), atol=atol,
                               rtol=0)


def pinholes():
    kw = dict(K_VALUES)
    return (jcam.Pinhole.from_values(**kw),
            tcam.Pinhole.from_values(**kw, device="cpu"))


def models():
    """(name, JAX model, port model) for the four camera models."""
    jK, tK = pinholes()
    k3, p2, k4 = [-0.21, 0.05, -0.004], [1.2e-3, -8e-4], [0.02, -0.01,
                                                            3e-3, -5e-4]
    return [
        ("pinhole", jK, tK),
        ("brown_conrady",
         jcam.BrownConrady.from_values(410.0, 405.0, 161.5, 118.0, k3, p2,
                                       0.7),
         tcam.BrownConrady.from_values(410.0, 405.0, 161.5, 118.0, k3, p2,
                                       0.7, device="cpu")),
        ("kannala_brandt", jcam.KannalaBrandt(jK, J(k4)),
         tcam.KannalaBrandt(tK, T(k4))),
        ("omnidirectional",
         jcam.Omnidirectional(jK, J(k3), J(p2), J(0.8)),
         tcam.Omnidirectional(tK, T(k3), T(p2), T(0.8))),
    ]


@pytest.mark.parametrize("name,jm,tm", models(),
                         ids=[m[0] for m in models()])
def test_project_backproject(name, jm, tm):
    rs = np.random.RandomState(0)
    X = rs.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (200, 3))
    uv = rs.uniform([0, 0], [320, 240], (200, 2))
    close(tm.project(T(X)).numpy(), jm.project(J(X)), atol=1e-3)
    ray_t = tm.backproject(T(uv)).numpy()
    close(ray_t, jm.backproject(J(uv)), atol=1e-6)
    if name in ("pinhole", "brown_conrady"):
        # Round trip: the ray projects back to its pixel.
        back = tm.project(torch.from_numpy(ray_t)).numpy()
        close(back, uv, atol=2e-3 if name == "brown_conrady" else 1e-3)


def test_brown_conrady_distort_undistort():
    rs = np.random.RandomState(1)
    _, jbc, tbc = models()[1]
    xn = rs.uniform(-0.4, 0.4, (300, 2))
    close(tbc.distort(T(xn)).numpy(), jbc.distort(J(xn)), atol=1e-6)
    for iters in (1, 3, 10):
        close(tbc.undistort(T(xn), iters).numpy(),
              jbc.undistort(J(xn), iters), atol=1e-6)
    xu = tbc.undistort(tbc.distort(T(xn)))
    close(xu.numpy(), xn, atol=1e-4)


def test_kannala_brandt_newton_iterations():
    jK, tK = pinholes()
    k4 = [0.02, -0.01, 3e-3, -5e-4]
    jkb, tkb = jcam.KannalaBrandt(jK, J(k4)), tcam.KannalaBrandt(tK, T(k4))
    uv = np.random.RandomState(2).uniform([0, 0], [320, 240], (100, 2))
    uv[0] = [161.5, 118.0]                    # the principal point: rd = 0
    for iters in (1, 4, 10):
        close(tkb.backproject(T(uv), iters).numpy(),
              jkb.backproject(J(uv), iters), atol=1e-6)


@pytest.mark.parametrize("name,jm,tm", models(),
                         ids=[m[0] for m in models()])
def test_undistortion_maps(name, jm, tm):
    mu_j, mv_j = jcam.undistortion_maps(jm, 24, 32)
    mu_t, mv_t = tcam.undistortion_maps(tm, 24, 32)
    assert mu_t.shape == (24, 32) and mu_t.dtype == torch.float32
    close(mu_t.numpy(), mu_j, atol=1e-3)
    close(mv_t.numpy(), mv_j, atol=1e-3)


def test_matrix_and_from_matrix():
    jK, tK = pinholes()
    close(tK.matrix().numpy(), jK.matrix(), atol=0)
    M = np.array([[300.0, 0.5, 160.0], [0, 310.0, 120.0], [0, 0, 1]])
    tK2 = tcam.Pinhole.from_matrix(M, device="cpu")
    jK2 = jcam.Pinhole.from_matrix(M)
    for a, b in zip(tK2, jK2):
        assert a.dtype == torch.float32
        close(a.numpy(), b, atol=0)


def test_camera_constructors_take_the_device():
    kw = dict(K_VALUES)
    for cam in (tcam.Pinhole.from_values(**kw, device="cpu"),
                tcam.BrownConrady.from_values(1.0, 1.0, 0.0, 0.0,
                                              device="cpu")):
        flat = [t for t in cam if torch.is_tensor(t)] + (
            list(cam.K) if hasattr(cam, "K") else [])
        assert all(t.device.type == "cpu" for t in flat)


# ---------------------------------------------------------------------------
# warps and color
# ---------------------------------------------------------------------------

def _image(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(24, 32), (24, 32, 3)])
def test_warp_bilinear(shape):
    img = _image(3, shape)
    rs = np.random.RandomState(4)
    mx = rs.uniform(-3, 35, (20, 28))         # some samples fall outside
    my = rs.uniform(-3, 27, (20, 28))
    mx[0, :4] = [0.0, 31.0, 31.0001, -1e-4]    # on and just past the edges
    for fill in (0.0, -1.0):
        ref = jtf.warp_bilinear(J(img), J(mx), J(my), fill)
        got = ttf.warp_bilinear(T(img), T(mx), T(my), fill)
        assert got.shape == ref.shape
        close(got.numpy(), ref, atol=1e-5)


def test_warp_homography():
    img = _image(5, (30, 40))
    th = 0.1
    H = np.array([[np.cos(th), -np.sin(th), 3.0],
                  [np.sin(th), np.cos(th), -2.0],
                  [1e-4, -2e-4, 1.0]])
    Hi = np.linalg.inv(H)
    ref = jtf.warp_homography(J(img), J(Hi), 28, 36, 0.25)
    got = ttf.warp_homography(T(img), T(Hi), 28, 36, 0.25)
    assert got.shape == (28, 36)
    close(got.numpy(), ref, atol=1e-5)


def test_undistortion_warp_end_to_end():
    """undistortion_maps -> warp_bilinear, the pipeline's undistortion."""
    img = _image(6, (24, 32))
    _, jbc, tbc = models()[1]
    ref = jtf.warp_bilinear(J(img), *jcam.undistortion_maps(jbc, 24, 32))
    got = ttf.warp_bilinear(T(img), *tcam.undistortion_maps(tbc, 24, 32))
    close(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("shape,dtype", [
    ((12, 16), np.uint8), ((12, 16), np.float32), ((12, 16, 3), np.uint8),
    ((12, 16, 3), np.float64), ((12, 16, 4), np.uint8),
    ((12, 16, 4), np.float32)])
def test_gray_from_any(shape, dtype):
    rs = np.random.RandomState(7)
    img = (rs.randint(0, 256, shape).astype(dtype) if dtype == np.uint8
           else rs.rand(*shape).astype(dtype))
    ref = jcolor.gray_from_any(jnp.asarray(img))
    for given in (img, torch.from_numpy(img)):
        got = tcolor.gray_from_any(given)
        assert got.dtype == torch.float32 and got.shape == shape[:2]
        close(got.numpy(), ref, atol=1e-6)
    if len(shape) == 3:
        close(tcolor.rgb_to_gray(T(img)).numpy(),
              jcolor.rgb_to_gray(J(img)), atol=1e-4)
