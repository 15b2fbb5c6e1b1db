"""Port parity: ``image/segmentation.py``, ``image/slic.py``,
``image/deriche.py`` and ``image/im2col.py``.

The same seeded NumPy inputs, cast to float32 explicitly (the suite's
conftest turns on JAX x64), go through the JAX function and the port's on
the CPU. Tolerances:

- integer labels and masks (Otsu's mask, adaptive threshold, connected
  components, watershed): exact; Otsu's threshold: exact;
- SLIC: labels exact, centres within 1e-4;
- Deriche and ``gemm_conv2d``: within 1e-5 relative to the output's
  largest magnitude.

The cases are the twins of ``tests/test_image_advanced.py``'s Otsu,
adaptive-threshold, CCL, watershed and SLIC tests, of
``tests/test_misc_modules.py``'s Deriche tests and of
``tests/test_io_misc.py::test_im2col_gemm_conv``, plus direct comparisons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sara_tpu.image import deriche as jder
from sara_tpu.image import im2col as jim
from sara_tpu.image import segmentation as jseg
from sara_tpu.image import slic as jslic
from sara_tpu_torch.image import deriche as tder
from sara_tpu_torch.image import im2col as tim
from sara_tpu_torch.image import segmentation as tseg
from sara_tpu_torch.image import slic as tslic
from sara_tpu_torch.image.filtering import gaussian_blur


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers, and
    the propagations are hundreds of small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel_err(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# --- Otsu ------------------------------------------------------------------

def _bimodal(seed, lo=0.2, hi=0.8, spread=0.02, shape=(20, 50)):
    rs = np.random.RandomState(seed)
    n = shape[0] * shape[1] // 2
    img = np.concatenate([rs.normal(lo, spread, n), rs.normal(hi, spread, n)])
    return np.clip(img, 0, 1).reshape(shape).astype(np.float32)


def _same_otsu(img, bins=256):
    thr_j, mask_j = jseg.otsu_threshold(jnp.asarray(img), bins)
    thr_t, mask_t = tseg.otsu_threshold(t(img), bins)
    assert float(thr_t) == float(thr_j)
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    return float(thr_t), mask_t.numpy()


def test_otsu_bimodal():
    thr, mask = _same_otsu(_bimodal(0))
    assert 0.3 < thr < 0.7
    assert 0.4 < mask.mean() < 0.6


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_otsu_matches_twin(seed):
    rs = np.random.RandomState(seed)
    img = _bimodal(seed, lo=rs.uniform(0.1, 0.4), hi=rs.uniform(0.6, 0.9),
                   spread=0.08, shape=(64, 80))
    _same_otsu(img)
    _same_otsu(rs.rand(48, 64).astype(np.float32), bins=64)


@pytest.mark.parametrize("bins", [256, 100])
def test_otsu_on_bin_edges(bins):
    """Pixels exactly on the twin's bin edges (``jnp.histogram``'s), and on
    ``numpy.linspace``'s, 0 and 1 among them: the same threshold and mask.
    At 100 bins ``torch.histc`` (arithmetic bins) and ``torch.linspace``'s
    edges both bin these pixels otherwise."""
    rs = np.random.RandomState(bins)
    edges_j = np.asarray(jnp.histogram_bin_edges(
        jnp.zeros(1, jnp.float32), bins, (0.0, 1.0)))
    edges_np = np.linspace(0.0, 1.0, bins + 1, dtype=np.float32)
    for edges in (edges_j, edges_np):
        img = edges[rs.randint(0, bins + 1, (64, 64))]
        img[0, :3] = (0.0, 1.0, edges[bins // 2])
        _same_otsu(img, bins)
        hist_j = np.asarray(jnp.histogram(jnp.asarray(img).reshape(-1),
                                          bins=bins, range=(0.0, 1.0))[0])
        x = t(img).reshape(-1)
        by_histc = torch.histc(x, bins, 0.0, 1.0).numpy()
        idx = torch.bucketize(x, torch.linspace(0.0, 1.0, bins + 1),
                              right=True)
        by_linspace = torch.bincount(torch.where(x == 1.0, bins, idx),
                                     minlength=bins + 1)[1:].numpy()
        assert (np.array_equal(by_histc, hist_j)
                and np.array_equal(by_linspace, hist_j)) == (bins == 256)


# --- adaptive threshold ----------------------------------------------------

def test_adaptive_threshold():
    x = np.linspace(0, 0.5, 64)[None, :] * np.ones((64, 1))
    img = x.copy()
    img[30:34, 30:34] += 0.3
    img = img.astype(np.float32)
    m = tseg.adaptive_threshold(t(img), radius=8, offset=-0.05).numpy()
    assert m[31, 31]
    assert m.mean() < 0.2
    assert np.array_equal(m, np.asarray(jseg.adaptive_threshold(
        jnp.asarray(img), radius=8, offset=-0.05)))


@pytest.mark.parametrize("radius,offset", [(15, 0.02), (4, -0.01)])
def test_adaptive_threshold_matches_twin(radius, offset):
    img = np.random.RandomState(radius).rand(64, 96).astype(np.float32)
    got = tseg.adaptive_threshold(t(img), radius, offset).numpy()
    assert np.array_equal(got, np.asarray(jseg.adaptive_threshold(
        jnp.asarray(img), radius, offset)))


# --- connected components and watershed ------------------------------------

def test_connected_components_device():
    mask = np.zeros((32, 32), bool)
    mask[2:8, 2:8] = True
    mask[20:28, 20:28] = True
    lab = tseg.label_connected_components(t(mask), iters=32).numpy()
    assert lab.dtype == np.int32
    l1, l2 = lab[4, 4], lab[24, 24]
    assert l1 > 0 and l2 > 0 and l1 != l2
    assert (lab[2:8, 2:8] == l1).all()
    assert (lab[~mask] == 0).all()
    assert np.array_equal(lab, np.asarray(jseg.label_connected_components(
        jnp.asarray(mask), iters=32)))


@pytest.mark.parametrize("iters", [8, 64])
def test_connected_components_match_twin(iters):
    """Random masks touching every border (a wrapped shift would join
    components across them): labels equal the twin's, also part way
    (``iters`` = 8 is short of the diameters)."""
    mask = np.random.RandomState(iters).rand(64, 80) > 0.55
    lab = tseg.label_connected_components(t(mask), iters).numpy()
    assert np.array_equal(lab, np.asarray(jseg.label_connected_components(
        jnp.asarray(mask), iters=iters)))


def test_shift_does_not_wrap():
    a = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            got = tseg._shift2(a, dy, dx, 0).numpy()
            want = np.asarray(jseg._shift2(jnp.asarray(a.numpy()), dy, dx, 0))
            assert np.array_equal(got, want)
    assert np.array_equal(tseg._neighbor_max(-a, -100).numpy(),
                          np.asarray(jseg._neighbor_max(
                              jnp.asarray(-a.numpy()), -100)))


def test_watershed_two_basins():
    xs = np.arange(64, dtype=np.float32)
    relief = (np.abs(np.abs(xs - 32.0) - 16.0)[None, :]
              * np.ones((64, 1)) / 32.0).astype(np.float32)
    markers = np.zeros((64, 64), np.int32)
    markers[32, 16] = 1
    markers[32, 48] = 2
    lab = tseg.watershed(t(relief), t(markers)).numpy()
    assert lab[32, 10] == 1
    assert lab[32, 54] == 2
    assert (lab[:, :30] != 2).all()
    assert (lab[:, 34:] != 1).all()
    assert np.array_equal(lab, np.asarray(jseg.watershed(
        jnp.asarray(relief), jnp.asarray(markers))))


@pytest.mark.parametrize("levels,iters", [(64, 8), (16, 3)])
def test_watershed_matches_twin(levels, iters):
    rs = np.random.RandomState(levels)
    relief = rs.rand(64, 96).astype(np.float32)
    markers = np.zeros((64, 96), np.int32)
    markers[rs.randint(0, 64, 6), rs.randint(0, 96, 6)] = np.arange(1, 7)
    lab = tseg.watershed(t(relief), t(markers), levels, iters).numpy()
    assert lab.dtype == np.int32
    assert np.array_equal(lab, np.asarray(jseg.watershed(
        jnp.asarray(relief), jnp.asarray(markers), levels, iters)))


# --- SLIC ------------------------------------------------------------------

def test_slic_superpixels():
    img = np.zeros((64, 64), np.float32)
    img[:, 32:] = 1.0
    labels, centers = tslic.slic(t(img), grid=16, iters=5)
    lab = labels.numpy()
    assert lab.shape == (64, 64) and lab.dtype == np.int32
    assert not (set(np.unique(lab[:, :24])) & set(np.unique(lab[:, 40:])))
    for l in np.unique(lab):
        ys, xs = np.nonzero(lab == l)
        assert np.ptp(ys) <= 48 and np.ptp(xs) <= 48
    lj, cj = jslic.slic(jnp.asarray(img), grid=16, iters=5)
    assert np.array_equal(lab, np.asarray(lj))
    np.testing.assert_allclose(centers.numpy(), np.asarray(cj), atol=1e-4)


@pytest.mark.parametrize("shape,grid,compactness", [
    ((64, 64), 16, 0.1), ((96, 128), 16, 0.1), ((96, 128, 3), 12, 0.5),
    ((70, 90), 16, 0.1)])
def test_slic_matches_twin(shape, grid, compactness):
    """Smooth random images (gray, colour, a size the grid does not
    divide): labels equal, centres within 1e-4."""
    rs = np.random.RandomState(sum(shape))
    img = rs.rand(*shape).astype(np.float32)
    img = ((img + np.roll(img, 3, 0) + np.roll(img, 5, 1)) / 3).astype(
        np.float32)
    lab, cen = tslic.slic(t(img), grid, 10, compactness)
    lj, cj = jslic.slic(jnp.asarray(img), grid, 10, compactness)
    assert np.array_equal(lab.numpy(), np.asarray(lj))
    np.testing.assert_allclose(cen.numpy(), np.asarray(cj), atol=1e-4,
                               rtol=0)


# --- Deriche ---------------------------------------------------------------

def test_deriche_matches_gaussian():
    img = np.random.default_rng(42).random((64, 96)).astype(np.float32)
    a = tder.deriche_blur(t(img), 4.0).numpy()
    b = gaussian_blur(t(img), 4.0).numpy()
    assert np.abs(a - b)[12:-12, 12:-12].max() < 0.02
    assert rel_err(a, jder.deriche_blur(jnp.asarray(img), 4.0)) <= 1e-5


def test_deriche_preserves_constant():
    img = np.full((48, 48), 0.7, np.float32)
    out = tder.deriche_blur(t(img), 3.0).numpy()
    np.testing.assert_allclose(out[10:-10, 10:-10], 0.7, atol=1e-3)
    assert rel_err(out, jder.deriche_blur(jnp.asarray(img), 3.0)) <= 1e-5


@pytest.mark.parametrize("sigma,tol", [(1.0, 0.06), (2.0, 0.02),
                                       (4.0, 0.02), (8.0, 0.03)])
def test_deriche_accuracy_across_sigmas(sigma, tol):
    img = np.random.default_rng(42).random((96, 128)).astype(np.float32)
    a = tder.deriche_blur(t(img), sigma).numpy()
    b = gaussian_blur(t(img), sigma).numpy()
    m = min(4 * int(sigma), 30)
    assert np.abs(a[m:-m, m:-m] - b[m:-m, m:-m]).max() < tol
    assert rel_err(a, jder.deriche_blur(jnp.asarray(img), sigma)) <= 1e-5


def test_deriche_coefficients_are_the_twins():
    for sigma in (0.7, 2.0, 5.5):
        want = [float(v) for v in jder._deriche_coeffs(sigma, jnp.float32)]
        assert list(tder._deriche_coeffs(sigma, torch.float32)) == want


# --- im2col / GEMM convolution --------------------------------------------

def test_im2col_gemm_conv():
    rng = np.random.default_rng(42)
    img = rng.random((16, 20)).astype(np.float32)
    k = rng.random((3, 3)).astype(np.float32)
    ours = tim.gemm_conv2d(t(img), t(k)).numpy()
    from scipy.signal import correlate2d

    np.testing.assert_allclose(ours, correlate2d(img, k, mode="valid"),
                               atol=1e-5)
    assert rel_err(ours, jim.gemm_conv2d(jnp.asarray(img),
                                         jnp.asarray(k))) <= 1e-5


@pytest.mark.parametrize("kh,kw,stride", [(7, 7, 1), (3, 5, 2), (4, 4, 3)])
def test_im2col_matches_twin(kh, kw, stride):
    rs = np.random.RandomState(kh * 10 + kw)
    img = rs.rand(64, 90).astype(np.float32)
    k = rs.normal(size=(kh, kw)).astype(np.float32)
    cols, shape = tim.im2col(t(img), kh, kw, stride)
    cj, sj = jim.im2col(jnp.asarray(img), kh, kw, stride)
    assert shape == tuple(sj)
    assert np.array_equal(cols.numpy(), np.asarray(cj))
    got = tim.gemm_conv2d(t(img), t(k), stride).numpy()
    assert rel_err(got, jim.gemm_conv2d(jnp.asarray(img), jnp.asarray(k),
                                        stride=stride)) <= 1e-5
