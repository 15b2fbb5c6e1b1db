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


# ---------------------------------------------------------------------------
# bfloat16 maps (SIFTParams.low_precision), histograms and peaks (F1, F2)
# ---------------------------------------------------------------------------

# bfloat16 keeps 8 significant bits: one rounding is within 2^-9 relative.
# The maps round the binned magnitudes, the taps and each of the two blur
# passes, and the two packages accumulate the passes in different orders,
# so a map value can land up to a few bfloat16 steps (2^-8 each) apart;
# every term is non-negative, so the bound is relative: 4 steps, 2^-6.
BF16_RTOL = 2.0 ** -6


@pytest.mark.parametrize("downsample", [1, 2])
def test_orientation_maps_bf16(grads, downsample):
    gx, gy = grads
    a = jori.orientation_maps(jnp.asarray(gx), jnp.asarray(gy), SIGMAS,
                              compute_dtype=jnp.bfloat16,
                              downsample=downsample)
    b = tori.orientation_maps(torch.from_numpy(gx), torch.from_numpy(gy),
                              SIGMAS, compute_dtype=torch.bfloat16,
                              downsample=downsample)
    assert a.dtype == jnp.bfloat16 and b.dtype == torch.bfloat16
    a = np.asarray(a.astype(jnp.float32))
    b = b.float().numpy()
    np.testing.assert_allclose(b, a, rtol=BF16_RTOL,
                               atol=1e-6 * float(np.abs(a).max()))
    f32 = np.asarray(jori.orientation_maps(jnp.asarray(gx), jnp.asarray(gy),
                                           SIGMAS, downsample=downsample))
    assert np.abs(b - f32).max() > 0      # the bf16 branch is really taken


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("downsample", [1, 2])
def test_orientation_histograms_and_dominant_orientations(
        grads, downsample, compute_dtype):
    gx, gy = grads
    rs = np.random.RandomState(3)
    K = 40
    x = rs.uniform(0, 35, K).astype(np.float32)
    y = rs.uniform(0, 27, K).astype(np.float32)
    s = rs.uniform(0, 2.4, K).astype(np.float32)
    jdt = None if compute_dtype is None else jnp.bfloat16
    tdt = None if compute_dtype is None else torch.bfloat16
    jargs = (jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(x),
             jnp.asarray(y), jnp.asarray(s), SIGMAS)
    targs = (torch.from_numpy(gx), torch.from_numpy(gy), torch.from_numpy(x),
             torch.from_numpy(y), torch.from_numpy(s), SIGMAS)
    ha = jori.orientation_histograms(*jargs, compute_dtype=jdt,
                                     downsample=downsample)
    hb = tori.orientation_histograms(*targs, compute_dtype=tdt,
                                     downsample=downsample)
    assert hb.dtype == torch.float32
    ha = np.asarray(ha)
    rtol = 1e-5 if compute_dtype is None else BF16_RTOL
    np.testing.assert_allclose(hb.numpy(), ha, rtol=rtol,
                               atol=1e-5 * float(np.abs(ha).max()))
    ta, va = jori.dominant_orientations(*jargs, max_peaks=2,
                                        compute_dtype=jdt,
                                        downsample=downsample)
    tb, vb = tori.dominant_orientations(*targs, max_peaks=2,
                                        compute_dtype=tdt,
                                        downsample=downsample)
    ta, va = np.asarray(ta), np.asarray(va)
    tb, vb = tb.numpy(), vb.numpy()
    if compute_dtype is None:
        np.testing.assert_array_equal(vb, va)
        d = np.abs(np.angle(np.exp(1j * (ta - tb))))[va]
        assert d.max() < 1e-3
    else:
        # bf16 rounding can swap near-equal peaks; the primary peaks
        # agree where both keep them.
        both = va[:, 0] & vb[:, 0]
        assert both.mean() > 0.9
        d = np.abs(np.angle(np.exp(1j * (ta[both, 0] - tb[both, 0]))))
        assert np.median(d) < 0.02


def _textured_image(h=160, w=200, seed=3):
    rs = np.random.RandomState(seed)
    img = rs.rand(h // 8, w // 8)
    img = np.kron(img, np.ones((8, 8)))
    yy, xx = np.mgrid[0:h, 0:w]
    img = img + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    return img.astype(np.float32)


def test_halfres_orientation_matches_exact():
    """tests/test_orientation_downsample.py's twin on the port alone:
    primary orientation peaks from the stride-2 maps within its gates of
    the full-resolution ones."""
    from sara_tpu_torch.features.dog import DoGParams, detect_dog_octave
    from sara_tpu_torch.image.differential import gradient as tgradient
    from sara_tpu_torch.image.pyramid import (PyramidParams, dog_pyramid,
                                              gaussian_pyramid)

    img = torch.from_numpy(_textured_image())
    gp = gaussian_pyramid(img, PyramidParams())
    dg = dog_pyramid(gp)
    gauss, dog = gp.octaves[0], dg.octaves[0]
    det = detect_dog_octave(dog, DoGParams(capacity=256))
    gx, gy = tgradient(gauss[:-1])
    t1, v1 = tori.dominant_orientations(gx, gy, det["x"], det["y"],
                                        det["s"], gp.sigmas[:-1],
                                        max_peaks=2, downsample=1)
    t2, v2 = tori.dominant_orientations(gx, gy, det["x"], det["y"],
                                        det["s"], gp.sigmas[:-1],
                                        max_peaks=2, downsample=2)
    m = det["mask"].numpy()
    assert m.sum() >= 30, "fixture produced too few keypoints"
    t1, t2, v1, v2 = (a.numpy() for a in (t1, t2, v1, v2))
    both = m & v1[:, 0] & v2[:, 0]
    d = np.abs(np.angle(np.exp(1j * (t1[both, 0] - t2[both, 0]))))
    assert np.median(d) < 0.05
    t1m, v1m, t2m = t1[both], v1[both], t2[both]
    dmin = np.full(len(t2m), np.inf)
    for p_ in range(t1m.shape[1]):
        cand = np.abs(np.angle(np.exp(1j * (t1m[:, p_] - t2m[:, 0]))))
        dmin = np.minimum(dmin, np.where(v1m[:, p_], cand, np.inf))
    assert (dmin > 0.175).mean() < 0.07, f"{(dmin > 0.175).mean()}"
    assert (v1[m] == v2[m]).mean() > 0.95


def test_low_precision_reaches_orientation_maps(monkeypatch):
    """SIFTParams.low_precision reaches orientation_maps on any device
    (bfloat16, stride 2 under orientation_downsample=0); by default the
    reference's branch off a TPU runs (float32, stride 1)."""
    from sara_tpu_torch.features import api as tapi

    seen = []
    real = tapi.orientation_maps

    def spy(*a, compute_dtype=None, downsample=1, **kw):
        seen.append((compute_dtype, downsample))
        return real(*a, compute_dtype=compute_dtype, downsample=downsample,
                    **kw)

    monkeypatch.setattr(tapi, "orientation_maps", spy)
    img = _textured_image(64, 80)
    tapi.compute_sift_keypoints(img, tapi.SIFTParams(total_capacity=256),
                                device="cpu")
    assert seen and all(s == (None, 1) for s in seen)
    seen.clear()
    kp = tapi.compute_sift_keypoints(
        img, tapi.SIFTParams(total_capacity=256, low_precision=True),
        device="cpu")
    assert seen and all(s == (torch.bfloat16, 2) for s in seen)
    assert kp.descriptors.dtype == torch.float32 and int(kp.count()) > 0
    seen.clear()
    tapi.compute_sift_keypoints(
        img, tapi.SIFTParams(total_capacity=256, low_precision=True,
                             orientation_downsample=1), device="cpu")
    assert seen and all(s == (torch.bfloat16, 1) for s in seen)
