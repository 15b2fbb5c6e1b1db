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
