"""Port parity: DoG detection and bucketed top-k.

The port's ``detect_dog_octave`` is fed the JAX package's own DoG stack, so
both sides see bitwise-equal inputs: valid sets must be equal and refined
positions agree within 1e-4 px (float32 Newton steps).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.features import dog as jdog
from sara_tpu.image.pyramid import (PyramidParams, dog_pyramid,
                                    gaussian_pyramid)
from sara_tpu.ops import topk as jtopk
from sara_tpu_torch.features import dog as tdog
from sara_tpu_torch.ops import topk as ttopk


def _texture(seed, shape):
    from scipy.ndimage import gaussian_filter

    t = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return (0.6 * gaussian_filter(t, 1.5) + 0.4 * gaussian_filter(t, 4)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_dogs():
    img = _texture(0, (96, 128))
    gp = gaussian_pyramid(jnp.asarray(img), PyramidParams(first_octave=0))
    return [np.asarray(o) for o in dog_pyramid(gp).octaves]


@pytest.mark.parametrize("octave", [0, 1])
@pytest.mark.parametrize("capacity,iters", [(64, 2), (256, 5)])
def test_detect_dog_octave(jax_dogs, octave, capacity, iters):
    dog = jax_dogs[octave]
    rj = jdog.detect_dog_octave(
        jnp.asarray(dog), jdog.DoGParams(capacity=capacity,
                                         refine_iters=iters))
    rt = tdog.detect_dog_octave(
        torch.from_numpy(dog.copy()),
        tdog.DoGParams(capacity=capacity, refine_iters=iters))
    mj = np.asarray(rj["mask"])
    mt = rt["mask"].numpy()
    assert mj.sum() > 0
    # Same top-k order on distinct scores: valid slots line up.
    np.testing.assert_array_equal(mj, mt)
    for key in ("x", "y", "s"):
        np.testing.assert_allclose(np.asarray(rj[key])[mj],
                                   rt[key].numpy()[mt], atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(rj["value"])[mj],
                               rt["value"].numpy()[mt], atol=1e-6, rtol=0)


def test_stencil_extrema_and_derivative_field(jax_dogs):
    dog = jax_dogs[1]
    for a, b in zip(jdog._stencil_extrema(jnp.asarray(dog)),
                    tdog._stencil_extrema(torch.from_numpy(dog.copy()))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(
        np.asarray(jdog._derivative_field(jnp.asarray(dog))),
        tdog._derivative_field(torch.from_numpy(dog.copy())).numpy(),
        atol=1e-7, rtol=0)


def test_solve3():
    rs = np.random.RandomState(2)
    hcomp = rs.randn(6, 50).astype(np.float32)
    hcomp[:3] += 4.0   # well-conditioned diagonals
    g = rs.randn(50, 3).astype(np.float32)
    a = jdog._solve3(tuple(jnp.asarray(h) for h in hcomp), jnp.asarray(g))
    b = tdog._solve3(tuple(torch.from_numpy(h) for h in hcomp),
                     torch.from_numpy(g))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n,k", [
    (5000, 100),        # small: exact top-k
    (200_000, 1000),    # bucketed path (n > max(4k, 16384))
    (300_000, 4096),
])
def test_bucketed_top_k(n, k):
    rs = np.random.RandomState(n)
    score = np.full(n, -1.0, np.float32)
    live = rs.choice(n, size=n // 20, replace=False)
    # Distinct scores: tie order is not part of either contract.
    score[live] = (rs.permutation(live.size) + 1.0) / live.size
    vj, ij = jtopk.bucketed_top_k(jnp.asarray(score), k)
    vt, it = ttopk.bucketed_top_k(torch.from_numpy(score), k)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
