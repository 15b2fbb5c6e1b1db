"""Port parity: SIFT descriptors, the per-octave pipeline and the frontend.

Stage by stage, the port gets the JAX package's own intermediates (its
orientation maps, its Gaussian and DoG octaves) and must agree tightly:
descriptors to 1e-5 from the same maps, and the whole per-octave stage to
1e-4 from the same octaves.

End to end, each side builds its own float32 pyramid. The two pyramids
agree to a few ulps (~3e-7: XLA's and PyTorch's convolutions sum in another
order), and Newton refinement amplifies that to ~5e-4 px on poorly
conditioned extrema, which moves those descriptors by up to ~1e-3 (or
flips a nearest sample). So end to end the keypoint sets are compared by
overlap, and descriptors of paired keypoints are held to 1e-4 for at least
95% of the pairs. Masked rows are never compared: ``-inf`` ties order them
arbitrarily.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.features import api as japi
from sara_tpu.features import sift as jsift
from sara_tpu.features.dog import DoGParams as JaxDoGParams
from sara_tpu.image.pyramid import (PyramidParams, dog_pyramid,
                                    gaussian_pyramid)
from sara_tpu_torch.convert import params_from_jax
from sara_tpu_torch.features import api as tapi
from sara_tpu_torch.features import sift as tsift
from sara_tpu_torch.ops import patch_sampler as ps

sys.path.insert(0, str(Path(__file__).resolve().parent))
from render3d import make_room  # noqa: E402

SIGMAS = (1.6, 2.0159, 2.5398)


def _jax_params(nearest: bool, first_octave: int = -1):
    """96x128 frontend with capacities 256 / 512: at first_octave=-1 the
    slice configuration (bilinear descriptors) or the nearest default; at
    first_octave=0 the visual-odometry configuration (bilinear), cut to
    the same capacities."""
    return japi.SIFTParams(pyramid=PyramidParams(first_octave=first_octave),
                           dog=JaxDoGParams(capacity=256, refine_iters=2),
                           total_capacity=512,
                           desc_sample_nearest=nearest)


@pytest.fixture(scope="module")
def image():
    return make_room(seed=0, tex_size=256)[1].tex[:96, :128] \
        .astype(np.float32)


@pytest.fixture(scope="module")
def field_problem():
    rs = np.random.RandomState(0)
    S, H, W, K = 3, 40, 48, 30
    maps = rs.rand(S, H, W, 36).astype(np.float32)
    x = rs.uniform(-3, W + 2, K).astype(np.float32)
    y = rs.uniform(-3, H + 2, K).astype(np.float32)
    s = rs.uniform(0, S - 1, K).astype(np.float32)
    th = rs.uniform(-3.1, 3.1, K).astype(np.float32)
    return maps, x, y, s, th


@pytest.mark.parametrize("sampler,bilinear", [
    ("gather", True), ("gather", False), ("kernel", True), ("auto", True)])
def test_sift_descriptors_field(field_problem, sampler, bilinear):
    maps, x, y, s, th = field_problem
    ref = jsift.sift_descriptors_field(
        *(jnp.asarray(a) for a in (maps, x, y, s, th)), SIGMAS,
        bilinear=bilinear, sampler="gather")
    before = ps.LAUNCHES
    out = tsift.sift_descriptors_field(
        *(torch.from_numpy(a) for a in (maps, x, y, s, th)), SIGMAS,
        bilinear=bilinear, sampler=sampler)
    assert ps.LAUNCHES == before            # CPU tensors launch nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("bilinear", [True, False])
def test_sift_descriptors_exact_grid(bilinear):
    from scipy.ndimage import gaussian_filter

    rs = np.random.RandomState(1)
    g = np.stack([gaussian_filter(rs.randn(36, 44), 1.5) for _ in range(6)]
                 ).astype(np.float32)
    gx, gy = g[:3], g[3:]
    K = 20
    x = rs.uniform(2, 42, K).astype(np.float32)
    y = rs.uniform(2, 34, K).astype(np.float32)
    s = rs.uniform(0, 2, K).astype(np.float32)
    th = rs.uniform(-3.1, 3.1, K).astype(np.float32)
    ref = jsift.sift_descriptors(*(jnp.asarray(a) for a in (gx, gy, x, y, s,
                                                            th)),
                                 SIGMAS, bilinear=bilinear)
    out = tsift.sift_descriptors(*(torch.from_numpy(a) for a in (gx, gy, x,
                                                                 y, s, th)),
                                 SIGMAS, bilinear=bilinear)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_root_sift():
    d = np.random.RandomState(2).rand(9, 128).astype(np.float32)
    np.testing.assert_allclose(tsift.root_sift(torch.from_numpy(d)).numpy(),
                               np.asarray(jsift.root_sift(jnp.asarray(d))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("nearest", [False, True])
def test_process_octave_from_jax_octaves(image, nearest):
    """The port's per-octave stage on the JAX package's own octaves."""
    jp = _jax_params(nearest)
    tp = params_from_jax(jp)
    gp = gaussian_pyramid(jnp.asarray(image), jp.pyramid)
    dg = dog_pyramid(gp)
    checked = 0
    for gauss, dog in zip(gp.octaves[:2], dg.octaves[:2]):
        s_, h_, w_ = dog.shape
        cap = min(jp.dog.capacity, max(64, (s_ * h_ * w_) // 512))
        rj = japi._process_octave(gauss, dog, dataclasses.replace(
            jp, dog=dataclasses.replace(jp.dog, capacity=cap)), gp.sigmas)
        rt = tapi._process_octave(
            torch.from_numpy(np.array(gauss)), torch.from_numpy(np.array(dog)),
            dataclasses.replace(tp, dog=dataclasses.replace(tp.dog,
                                                            capacity=cap)),
            gp.sigmas)
        mj = np.asarray(rj["mask"])
        np.testing.assert_array_equal(mj, rt["mask"].numpy())
        for key, atol in (("x", 1e-4), ("y", 1e-4), ("s", 1e-4),
                          ("theta", 1e-4), ("desc", 1e-4)):
            np.testing.assert_allclose(rt[key].numpy()[mj],
                                       np.asarray(rj[key])[mj], atol=atol,
                                       rtol=0, err_msg=key)
        checked += int(mj.sum())
    assert checked > 100


def _pair(kj, kt):
    """Pair each valid JAX keypoint with the port keypoint nearest in
    position + orientation (replicas share a position). Returns
    (paired mask over JAX rows, port row of each, position distance)."""
    mj = np.asarray(kj.mask)
    mt = kt.mask.numpy()
    xj, xt = np.asarray(kj.xy)[mj], kt.xy.numpy()[mt]
    oj, ot = np.asarray(kj.orientation)[mj], kt.orientation.numpy()[mt]
    dpos = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    dang = np.abs(np.angle(np.exp(1j * (oj[:, None] - ot[None]))))
    nn = (dpos + dang).argmin(axis=1)
    rows = np.arange(len(nn))
    paired = (dpos[rows, nn] < 0.5) & (dang[rows, nn] < 1e-2)
    return paired, nn, dpos[rows, nn]


@pytest.mark.parametrize("nearest,first_octave,ds", [
    (False, -1, 0), (True, -1, 0), (False, 0, 0), (False, -1, 2)],
    ids=["slice", "nearest", "vo", "orientation_ds2"])
def test_compute_sift_keypoints_end_to_end(image, nearest, first_octave, ds):
    """Case orientation_ds2: orientation maps at stride 2, against the
    reference's CPU harness with the same ``orientation_downsample``."""
    jp = dataclasses.replace(_jax_params(nearest, first_octave),
                             orientation_downsample=ds)
    kj = japi.compute_sift_keypoints(jnp.asarray(image), jp)
    before = ps.LAUNCHES
    kt = tapi.compute_sift_keypoints(image, params_from_jax(jp),
                                     device="cpu")
    assert ps.LAUNCHES == before
    assert kt.capacity == kj.capacity == 512
    nj, nt = int(kj.count()), int(kt.count())
    assert nj > 100 and abs(nj - nt) <= 0.05 * nj
    paired, nn, dist = _pair(kj, kt)
    assert paired.mean() >= 0.95
    assert dist[paired].max() < 1e-3
    mj = np.asarray(kj.mask)
    dj = np.asarray(kj.descriptors)[mj][paired]
    dt = kt.descriptors.numpy()[kt.mask.numpy()][nn[paired]]
    err = np.abs(dj - dt).max(axis=1)
    assert (err <= 1e-4).mean() >= 0.95
    sj = np.asarray(kj.scale)[mj][paired]
    st = kt.scale.numpy()[kt.mask.numpy()][nn[paired]]
    np.testing.assert_allclose(st, sj, rtol=1e-3)


def test_slice_configuration_kernel_path_equals_gather_path(image):
    """sampler "kernel" (plain version on the CPU) and bilinear gathers
    compute one function: identical keypoints, descriptors to 1e-5."""
    tp = params_from_jax(_jax_params(nearest=False))
    a = tapi.compute_sift_keypoints(
        image, dataclasses.replace(tp, desc_sampler="kernel"), device="cpu")
    b = tapi.compute_sift_keypoints(image, tp, device="cpu")
    for f in ("xy", "scale", "orientation", "response", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    m = a.mask
    assert (a.descriptors[m] - b.descriptors[m]).abs().max() <= 1e-5


def test_kernel_sampler_nearest_on_a_declined_geometry():
    """24x24 maps: the JAX "pallas" sampler declines the window and takes
    nearest gathers; the port's "kernel" sampler must do the same with
    bilinear=False (the geometry of tests/test_patch_sampler.py's
    fallback test), to 1e-6."""
    rs = np.random.RandomState(0)
    S, H, W, K = 3, 24, 24, 6
    maps = rs.rand(S, H, W, 36).astype(np.float32)
    x = rs.uniform(4, W - 5, K).astype(np.float32)
    y = rs.uniform(4, H - 5, K).astype(np.float32)
    s = rs.uniform(0, S - 1, K).astype(np.float32)
    th = rs.uniform(-3, 3, K).astype(np.float32)
    sig = (1.6, 2.0, 2.5)
    ref = jsift.sift_descriptors_field(
        *(jnp.asarray(a) for a in (maps, x, y, s, th)), sig,
        bilinear=False, sampler="pallas")
    out = tsift.sift_descriptors_field(
        *(torch.from_numpy(a) for a in (maps, x, y, s, th)), sig,
        bilinear=False, sampler="kernel")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
