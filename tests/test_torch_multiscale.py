"""The port's feature extras (``sara_tpu_torch/features/{multiscale,affine,
dense}.py``) against their twins on the CPU: LoG, DoH and Harris-Laplace
keypoints by overlap (nearest within 0.5 px at a scale within 1%) on the
twin tests' scenes and on a seeded texture of the same size, affine shapes
and dense SIFT within 1e-4."""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.features import affine as jaff
from sara_tpu.features import dense as jdense
from sara_tpu.features import multiscale as jms
from sara_tpu_torch.features import affine as taff
from sara_tpu_torch.features import dense as tdense
from sara_tpu_torch.features import multiscale as tms

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import kp_overlap  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (the Tier-1 command runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texture(seed, shape):
    from scipy.ndimage import gaussian_filter

    t = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return (0.6 * gaussian_filter(t, 1.5) + 0.4 * gaussian_filter(t, 4)
            ).astype(np.float32)


def _blob_image(h, w, cx, cy, sigma):
    ys, xs = np.mgrid[0:h, 0:w]
    r2 = (xs - cx) ** 2 + (ys - cy) ** 2
    return (1.0 - np.exp(-r2 / (2 * sigma ** 2))).astype(np.float32)


def _square():
    img = np.zeros((96, 96), np.float32)
    img[32:64, 32:64] = 1.0
    return img


SCENES = {
    "log": (_blob_image(96, 128, 64.0, 48.0, 6.0), [[64, 48]]),
    "doh": (_blob_image(96, 128, 40.0, 40.0, 5.0), [[40, 40]]),
    "harris": (_square(), [[32, 32], [32, 63], [63, 32], [63, 63]]),
}
DETECTORS = {
    "log": ("compute_log_keypoints", 2.0),
    "doh": ("compute_doh_keypoints", 2.0),
    "harris": ("compute_harris_laplace_keypoints", 4.0),
}


def _both(det, image):
    name = DETECTORS[det][0]
    jk = getattr(jms, name)(jnp.asarray(image))
    tk = getattr(tms, name)(torch.from_numpy(image), device="cpu")
    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert tk.capacity == jk.capacity
    return (np.asarray(jk.xy)[jm], np.asarray(jk.scale)[jm],
            tk.xy.numpy()[tm], tk.scale.numpy()[tm])


# Keypoints of either set with no partner in the other, on the twin tests'
# scenes. The DoH scene's blob is symmetric about the diagonal x = y. The
# port's one extra DoH keypoint is a minimum at octave 1, (s, y, x) =
# (2, 17, 16): its mirror sample (2, 16, 17) holds the same value in the
# twin, a tie, so no strict extremum there; in the port the two differ by
# 4e-8 (-0.0077819740 against -0.0077819345). Measured: LoG 1 and 1
# keypoints, DoH 8 (twin) and 9 (port), Harris-Laplace 35 and 36, every
# other keypoint paired.
UNPAIRED_ON_TWIN_SCENE = {"log": 0, "doh": 1, "harris": 0}


@pytest.mark.parametrize("det", sorted(DETECTORS))
def test_detector_on_twin_scene(det):
    """The twin tests' scenes (``test_image_advanced.py``): the port finds
    what the twin test asserts, and the twin's keypoints, but for the
    mirror tie of ``UNPAIRED_ON_TWIN_SCENE``."""
    image, targets = SCENES[det]
    jxy, jsc, txy, tsc = _both(det, image)
    assert len(txy) > 0
    for c in targets:
        assert np.min(np.linalg.norm(txy - c, axis=1)) < DETECTORS[det][1]
    allowed = UNPAIRED_ON_TWIN_SCENE[det]
    for a, sa, b, sb in ((jxy, jsc, txy, tsc), (txy, tsc, jxy, jsc)):
        unpaired = round((1.0 - kp_overlap(a, sa, b, sb)) * len(a))
        assert unpaired <= allowed


@pytest.mark.parametrize("det", sorted(DETECTORS))
def test_detector_on_texture(det):
    """A seeded texture of the scene's size: the keypoint sets overlap both
    ways for at least 97% of the points."""
    image = _texture(3, SCENES[det][0].shape)
    jxy, jsc, txy, tsc = _both(det, image)
    assert len(jxy) > 30
    assert kp_overlap(jxy, jsc, txy, tsc) >= 0.97
    assert kp_overlap(txy, tsc, jxy, jsc) >= 0.97


def test_adapt_affine_shapes_matches_twin():
    """Shapes within 1e-4 on Harris-Laplace keypoints of a texture and on
    the twin test's anisotropic blob, the same convergence flags."""
    image = _texture(5, (96, 128))
    kp = jms.compute_harris_laplace_keypoints(jnp.asarray(image),
                                              capacity=64)
    m = np.asarray(kp.mask)
    xy = np.asarray(kp.xy, np.float32)[m][:48]
    sc = np.asarray(kp.scale, np.float32)[m][:48]
    ys, xs = np.mgrid[0:96, 0:128].astype(np.float32)
    image = image + np.exp(-(((xs - 64) / 12) ** 2 + ((ys - 48) / 4) ** 2))
    image = image.astype(np.float32)
    xy = np.concatenate([xy, [[64.0, 48.0]]]).astype(np.float32)
    sc = np.concatenate([sc, [4.0]]).astype(np.float32)
    mask = np.ones(len(xy), bool)
    mask[3] = False
    jS, jc = jaff.adapt_affine_shapes(jnp.asarray(image), jnp.asarray(xy),
                                      jnp.asarray(sc), jnp.asarray(mask))
    tS, tc = taff.adapt_affine_shapes(image, xy, sc, mask, device="cpu")
    assert len(xy) > 20
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=1e-4,
                               rtol=1e-4)
    S = tS.numpy()[-1]
    assert bool(tc[-1]) and S[0, 0] < 0.5 * S[1, 1]


@pytest.mark.parametrize("step", [8, 16])
def test_dense_sift_matches_twin(step):
    image = _texture(7, (72, 104))
    jxy, jd = jdense.dense_sift(jnp.asarray(image), step=step)
    txy, td = tdense.dense_sift(image, step=step, device="cpu")
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy, np.float32))
    assert td.shape == (len(jxy), 128)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
