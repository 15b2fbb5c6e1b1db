"""Port parity: image filtering, transforms, gradients and pyramids.

The same numpy-seeded float32 inputs go through ``sara_tpu`` (JAX on the
CPU) and ``sara_tpu_torch`` (PyTorch on the CPU). Tolerance 1e-5 absolute:
both sides compute in float32 and differ only in summation order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.image import differential as jdiff
from sara_tpu.image import filtering as jfilt
from sara_tpu.image import pyramid as jpyr
from sara_tpu.image import transform as jtr
from sara_tpu_torch.image import differential as tdiff
from sara_tpu_torch.image import filtering as tfilt
from sara_tpu_torch.image import pyramid as tpyr
from sara_tpu_torch.image import transform as ttr

ATOL = 1e-5


def _image(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.1])
@pytest.mark.parametrize("shape", [(40, 52), (3, 24, 36)])
def test_gaussian_blur(sigma, shape):
    x = _image(0, shape)
    _close(jfilt.gaussian_blur(jnp.asarray(x), sigma),
           tfilt.gaussian_blur(torch.from_numpy(x), sigma))


@pytest.mark.parametrize("kx,ky", [
    ([-1.0, 0.0, 1.0], [0.25, 0.5, 0.25]),          # derivative: flip matters
    ([0.1, 0.5, 0.2, -0.3, 0.7], [1.0, -2.0, 0.5]),  # asymmetric, unequal
])
def test_separable_conv2d(kx, ky):
    x = _image(1, (2, 30, 34))
    kx = np.asarray(kx, np.float32)
    ky = np.asarray(ky, np.float32)
    _close(jfilt.separable_conv2d(jnp.asarray(x), jnp.asarray(kx),
                                  jnp.asarray(ky)),
           tfilt.separable_conv2d(torch.from_numpy(x), kx, ky))


def test_gaussian_kernel_and_band_matrix():
    _close(jfilt.gaussian_kernel_1d(1.3), tfilt.gaussian_kernel_1d(1.3, device="cpu"))
    taps = np.array([0.2, 0.5, 0.3])
    np.testing.assert_array_equal(jfilt.band_matrix(taps, 11, 2),
                                  tfilt.band_matrix(taps, 11, 2))


def test_upscale2_downscale2():
    x = _image(2, (30, 40))
    _close(jtr.upscale2(jnp.asarray(x)), ttr.upscale2(torch.from_numpy(x)))
    np.testing.assert_array_equal(
        np.asarray(jtr.downscale2(jnp.asarray(x))),
        ttr.downscale2(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("out_hw", [(45, 61), (19, 27)])
def test_resize_bilinear(out_hw):
    """Enlarging and shrinking (JAX antialiases when shrinking)."""
    x = _image(3, (30, 40))
    _close(jtr.resize_bilinear(jnp.asarray(x), *out_hw),
           ttr.resize_bilinear(torch.from_numpy(x), *out_hw))


def test_bilinear_sample():
    rs = np.random.RandomState(4)
    img = rs.rand(20, 24, 3).astype(np.float32)
    x = rs.uniform(-2, 26, (7, 5)).astype(np.float32)
    y = rs.uniform(-2, 22, (7, 5)).astype(np.float32)
    _close(jtr.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                               jnp.asarray(y)),
           ttr.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                               torch.from_numpy(y)))


def test_gradient():
    x = _image(5, (4, 22, 26))
    for j, t in zip(jdiff.gradient(jnp.asarray(x)),
                    tdiff.gradient(torch.from_numpy(x))):
        _close(j, t)


@pytest.mark.parametrize("first_octave", [-1, 0])
def test_gaussian_and_dog_pyramid(first_octave):
    x = _image(6, (48, 64))
    gj = jpyr.gaussian_pyramid(jnp.asarray(x),
                               jpyr.PyramidParams(first_octave=first_octave))
    gt = tpyr.gaussian_pyramid(torch.from_numpy(x),
                               tpyr.PyramidParams(first_octave=first_octave))
    assert gj.octave_scales == gt.octave_scales
    assert gj.sigmas == gt.sigmas
    assert len(gj.octaves) == len(gt.octaves) >= 2
    for a, b in zip(gj.octaves, gt.octaves):
        assert a.shape == tuple(b.shape)
        _close(a, b)
    for a, b in zip(jpyr.dog_pyramid(gj).octaves,
                    tpyr.dog_pyramid(gt).octaves):
        _close(a, b)


# --- E0: the rest of filtering, differential and pyramid ------------------

RTOL = 1e-5


def _rel(j, t, floor=1e-6):
    """max |j - t| / max(|j|) within RTOL: relative to the field's scale
    (the differential operators' outputs straddle zero)."""
    j = np.asarray(j, np.float64)
    t = t.numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(np.abs(j).max(), floor)
    assert np.abs(j - t).max() / scale < RTOL, np.abs(j - t).max() / scale


@pytest.mark.parametrize("shape", [(30, 41), (2, 24, 36)])
def test_conv2d(shape):
    x = _image(7, shape)
    k = np.random.RandomState(8).randn(5, 3).astype(np.float32)
    _rel(jfilt.conv2d(jnp.asarray(x), jnp.asarray(k)),
         tfilt.conv2d(torch.from_numpy(x), torch.from_numpy(k)))


@pytest.mark.parametrize("radius", [1, 3])
def test_box_blur(radius):
    x = _image(9, (2, 33, 40))
    _rel(jfilt.box_blur(jnp.asarray(x), radius),
         tfilt.box_blur(torch.from_numpy(x), radius))


def test_sobel():
    x = _image(10, (35, 47))
    for j, t in zip(jfilt.sobel(jnp.asarray(x)),
                    tfilt.sobel(torch.from_numpy(x))):
        _rel(j, t)


@pytest.mark.parametrize("name", ["gradient_polar", "hessian"])
def test_differential_fields(name):
    x = _image(11, (3, 28, 30))
    jo = getattr(jdiff, name)(jnp.asarray(x))
    to = getattr(tdiff, name)(torch.from_numpy(x))
    for j, t in zip(jo, to):
        _rel(j, t)


def test_laplacian_and_shift_borders():
    """The 5-point Laplacian, and ``_shift``'s replicated borders at every
    offset the operators use."""
    x = _image(12, (26, 31))
    _rel(jdiff.laplacian(jnp.asarray(x)),
         tdiff.laplacian(torch.from_numpy(x)))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            np.testing.assert_array_equal(
                np.asarray(jdiff._shift(jnp.asarray(x), dy, dx)),
                tdiff._shift(torch.from_numpy(x), dy, dx).numpy())


@pytest.mark.parametrize("sigmas", [(1.0, 2.0), (0.8, 2.4)],
                         ids=["generic", "chessboard"])
def test_second_moment_and_harris(sigmas):
    """The structure tensor and Harris cornerness, at the chessboard
    detector's sigma_D = 0.8 and sigma_I = 2.4 among others."""
    x = _image(13, (48, 64))
    for j, t in zip(jdiff.second_moment_matrix(jnp.asarray(x), *sigmas),
                    tdiff.second_moment_matrix(torch.from_numpy(x),
                                               *sigmas)):
        _rel(j, t)
    _rel(jdiff.harris_cornerness(jnp.asarray(x), *sigmas, 0.04),
         tdiff.harris_cornerness(torch.from_numpy(x), *sigmas, 0.04))


@pytest.mark.parametrize("name", ["mean_curvature", "mean_curvature_flow"])
def test_mean_curvature(name):
    """On a smooth field (a circle's signed distance plus a ripple), and on
    a flat patch where the gradient vanishes (both give exact zeros)."""
    ys, xs = np.mgrid[0:40, 0:48].astype(np.float32)
    u = (np.hypot(xs - 20.3, ys - 18.7) - 9.0
         + 0.3 * np.sin(xs / 5.0)).astype(np.float32)
    u[:8, :8] = 1.0
    j = getattr(jdiff, name)(jnp.asarray(u))
    t = getattr(tdiff, name)(torch.from_numpy(u))
    _rel(j, t)
    assert (t.numpy()[1:6, 1:6] == 0).all()


def test_laplacian_pyramid():
    """Stage by stage: the reference's Gaussian pyramid goes to both sides
    (the two pyramids differ by a few ulps, which the Laplacian times
    sigma^2 would amplify past the tolerance)."""
    x = _image(14, (48, 64))
    gj = jpyr.gaussian_pyramid(jnp.asarray(x), jpyr.PyramidParams())
    gt = tpyr.GaussianPyramid(
        [torch.from_numpy(np.asarray(o)) for o in gj.octaves],
        gj.octave_scales, gj.sigmas)
    lj = jpyr.laplacian_pyramid(gj)
    lt = tpyr.laplacian_pyramid(gt)
    assert lj.octave_scales == lt.octave_scales and lj.sigmas == lt.sigmas
    for a, b in zip(lj.octaves, lt.octaves):
        _rel(a, b)


def test_image_package_exports_match_twin():
    import sara_tpu.image as jimage
    import sara_tpu_torch.image as timage

    assert set(jimage.__all__) == set(timage.__all__)
