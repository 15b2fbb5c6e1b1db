"""Port parity: orientation maps, their samples, smoothing and peaks.

Float32 on both sides. The maps are blurs with unnormalized taps (values up
to ~10), so they are held to 1e-5 absolute plus 1e-5 relative; samples of
the same maps and the histogram steps to 1e-5 absolute.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.features import orientation as jori
from sara_tpu.image.differential import gradient
from sara_tpu_torch.features import orientation as tori

SIGMAS = (1.6, 2.0159, 2.5398)


@pytest.fixture(scope="module")
def grads():
    from scipy.ndimage import gaussian_filter

    rs = np.random.RandomState(0)
    stack = np.stack([gaussian_filter(rs.rand(28, 36), 1.0 + i)
                      for i in range(3)]).astype(np.float32)
    gx, gy = gradient(jnp.asarray(stack))
    return np.array(gx), np.array(gy)     # writable copies for torch


@pytest.fixture(scope="module")
def maps(grads):
    return np.array(jori.orientation_maps(jnp.asarray(grads[0]),
                                          jnp.asarray(grads[1]), SIGMAS))


def test_binned_magnitude(grads):
    gx, gy = grads
    a = jori._binned_magnitude(jnp.asarray(gx[0]), jnp.asarray(gy[0]))
    b = tori._binned_magnitude(torch.from_numpy(gx[0]),
                               torch.from_numpy(gy[0]))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("downsample", [1, 2])
def test_orientation_maps(grads, downsample):
    gx, gy = grads
    a = jori.orientation_maps(jnp.asarray(gx), jnp.asarray(gy), SIGMAS,
                              downsample=downsample)
    b = tori.orientation_maps(torch.from_numpy(gx), torch.from_numpy(gy),
                              SIGMAS, downsample=downsample)
    assert a.shape == tuple(b.shape)
    assert b.is_contiguous()
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bilinear", [True, False])
def test_sample_orientation_maps(maps, bilinear):
    rs = np.random.RandomState(1)
    K = 40
    x = rs.uniform(-2, 38, K).astype(np.float32)
    y = rs.uniform(-2, 30, K).astype(np.float32)
    s = rs.uniform(0, 2.4, K).astype(np.float32)
    a = jori.sample_orientation_maps(jnp.asarray(maps), jnp.asarray(x),
                                     jnp.asarray(y), jnp.asarray(s),
                                     bilinear=bilinear)
    b = tori.sample_orientation_maps(torch.from_numpy(maps),
                                     torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(s), bilinear=bilinear)
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5, rtol=0)


def test_smoothing_and_peaks():
    rs = np.random.RandomState(2)
    hist = rs.rand(64, 36).astype(np.float32)
    hist[:4] = 0.0                               # no peak at all
    hist[4:8] = np.cos(np.arange(36) * (2 * np.pi / 36) * 2) + 1.0  # two
    a = jori.lowe_smooth(jnp.asarray(hist))
    b = tori.lowe_smooth(torch.from_numpy(hist))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6, rtol=0)

    tj, vj = jori.find_orientation_peaks(a, max_peaks=2)
    tt, vt = tori.find_orientation_peaks(b, max_peaks=2)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vj, vt.numpy())
    assert vj.sum() > 64 and not vj[:4].any()
    # Compare angles on the circle: -pi and pi are the same orientation.
    d = np.angle(np.exp(1j * (np.asarray(tj) - tt.numpy())))
    np.testing.assert_allclose(d[vj], 0.0, atol=1e-5)
