"""Port parity: ``image/edges.py`` and ``image/edge_chains.py``.

The same float32 images go through the JAX package (on the CPU) and the
port (CPU torch). The port's blurs differ from XLA's by a few ulps (a
standing difference), and so do its gradient magnitudes; Canny's NMS
compares neighbours that are exactly equal on a symmetric synthetic
board, so an ulp decides which of two tied pixels survives. Hence:
- Canny is bitwise on a step edge end to end, and on a rendered board once
  the reference's blur is fed to the port (all but a handful of tie
  pixels); end to end on the board every edge pixel of one package lies
  within one pixel of the other's.
- Hough lines (rho, theta, votes, in order) equal the reference's bit for
  bit, run as users run it: in a subprocess without the suite's x64, under
  which the reference's thetas, and so its votes, are float64. Fifteen
  cases (step, board, noisy board; K = 8 to 128), and a case where every
  edgel of a line lands in one bin.
- Chains are compared as point sets, segments within 0.5 px.
The twins of the reference's own edge tests follow; the real-image test
(``test_line_segments_on_real_image``, whose image is absent) gets a
synthetic twin.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.image import edge_chains as jec
from sara_tpu.image import edges as jed
from sara_tpu.image.filtering import gaussian_blur as jax_blur
from sara_tpu_torch.image import edge_chains as tec
from sara_tpu_torch.image import edges as ted

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_calibration import K_GT, _render_chessboard, _view_pose  # noqa
from tool_twins import run_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(w=64, at=32):
    img = np.zeros((64, w), np.float32)
    img[:, at:] = 1.0
    return img


def _board(noise=0.0):
    R, t = _view_pose(0.05, 0.1, -4.0, -3.0, 10.0)
    img = _render_chessboard(K_GT, R, t)[0]
    if noise:
        img = img + np.random.RandomState(0).normal(
            scale=noise, size=img.shape).astype(np.float32)
    return img.astype(np.float32)


def _square(h=120, w=160, angle=0.3):
    ys, xs = np.mgrid[0:h, 0:w].astype(float)
    c, s = np.cos(angle), np.sin(angle)
    xr = c * (xs - w / 2) + s * (ys - h / 2)
    yr = -s * (xs - w / 2) + c * (ys - h / 2)
    return ((np.abs(xr) < 40) & (np.abs(yr) < 25)).astype(np.float32)


def _canny_both(img, **kw):
    return (np.asarray(jed.canny(jnp.asarray(img), **kw)),
            ted.canny(torch.from_numpy(img), **kw).numpy())


def _within_one_px(a, b):
    """Every True pixel of ``a`` has a True pixel of ``b`` in its 3x3."""
    bp = np.pad(b, 1)
    near = np.zeros_like(b)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near |= bp[1 + dy:1 + dy + b.shape[0], 1 + dx:1 + dx + b.shape[1]]
    return bool((~a | near).all())


def _feed_reference_blur(monkeypatch):
    monkeypatch.setattr(ted, "gaussian_blur", lambda im, s: torch.from_numpy(
        np.asarray(jax_blur(jnp.asarray(im.numpy()), s))))


@pytest.mark.parametrize("w,at", [(64, 32), (80, 20), (64, 1)],
                         ids=["middle", "off_centre", "border"])
def test_canny_step_edge(w, at, monkeypatch):
    """End to end, within one pixel (the two columns beside a step tie in
    magnitude, and an ulp of the blur picks one); bitwise once the
    reference's blur is fed to the port."""
    ej, et = _canny_both(_step(w, at))
    assert et.any() and _within_one_px(et, ej) and _within_one_px(ej, et)
    _feed_reference_blur(monkeypatch)
    ej, et = _canny_both(_step(w, at))
    np.testing.assert_array_equal(et, ej)


@pytest.mark.parametrize("kw", [{}, dict(low=0.02, high=0.05)],
                         ids=["default", "low"])
def test_canny_board_with_reference_blur(kw, monkeypatch):
    """Stage by stage: the reference's blur fed to the port, then NMS and
    hysteresis (32 dilations) on both sides. What differs is a handful of
    NMS ties decided by one ulp of the gradient magnitude."""
    img = _board()
    _feed_reference_blur(monkeypatch)
    ej, et = _canny_both(img, **kw)
    assert (ej != et).sum() <= 0.002 * ej.sum(), ((ej != et).sum(), ej.sum())
    assert _within_one_px(et, ej) and _within_one_px(ej, et)


@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["clean", "noisy"])
def test_canny_board_end_to_end(noise):
    ej, et = _canny_both(_board(noise))
    assert abs(int(et.sum()) - int(ej.sum())) <= 0.02 * ej.sum()
    assert _within_one_px(et, ej) and _within_one_px(ej, et)


def test_canny_finds_step_edge():
    e = ted.canny(torch.from_numpy(_step()))
    assert e.dtype == torch.bool
    e = e.numpy()
    cols = np.nonzero(e.any(axis=0))[0]
    assert len(cols) > 0 and np.all(np.abs(cols - 31.5) < 3)
    assert e.any(axis=1).mean() > 0.8


def test_canny_flat_image_empty():
    assert not ted.canny(torch.full((64, 64), 0.5)).any()


# The images of the Hough cases and the numbers of lines asked for.
HOUGH_IMAGES = {"step": lambda: _step(64, 20), "board": _board,
                "noisy_board": lambda: _board(0.05)}
HOUGH_KS = (8, 16, 32, 64, 128)
# A dense random edge map and its K: 30% of 240x320 pixels vote, so
# rhos fall within an ulp of a bin's edge, and one ulp of a cosine or of
# x cos + y sin moves a vote (the named images move none).
DENSE_EDGES_K = 4096


def _dense_edges():
    return np.random.RandomState(0).rand(240, 320) < 0.3


def reference_hough(path):
    """The reference's Canny edges of each of ``HOUGH_IMAGES`` and its
    Hough lines at each of ``HOUGH_KS``, and its lines on the dense random
    edges, into an NPZ at ``path``. Run by ``run_jax``, without x64."""
    arrays = {"dense": _dense_edges()}
    for name, make in HOUGH_IMAGES.items():
        arrays[name] = np.asarray(jed.canny(jnp.asarray(make())))
    for name, ks in [(n, HOUGH_KS) for n in HOUGH_IMAGES] + [
            ("dense", (DENSE_EDGES_K,))]:
        for k in ks:
            arrays[f"{name}_{k}"] = np.stack([np.asarray(a) for a in (
                jed.hough_lines(jnp.asarray(arrays[name]), max_lines=k))])
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def hough_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("hough") / "reference.npz"
    run_jax("import test_torch_edges as t; import jax.numpy as jnp; "
            "assert jnp.asarray(1.0).dtype == jnp.float32; "
            f"t.reference_hough({str(path)!r})")
    return dict(np.load(path))


def _port_lines(ref, name, k):
    lines = ted.hough_lines(torch.from_numpy(ref[name]), max_lines=k)
    assert all(a.dtype == torch.float32 for a in lines)
    return np.stack([a.numpy() for a in lines])


@pytest.mark.parametrize("k", HOUGH_KS)
@pytest.mark.parametrize("name", list(HOUGH_IMAGES))
def test_hough_lines_equal_reference(hough_reference, name, k):
    """All K lines, in order, bit for bit: the same edges through the
    reference (no x64) and the port. Votes tie often (31 lines share the
    last vote on the step at K = 64), so this holds the tie order, the
    thetas, the bins and the rhos as XLA rounds them."""
    got = _port_lines(hough_reference, name, k)
    want = hough_reference[f"{name}_{k}"]
    for row, what in enumerate(("rho", "theta", "votes")):
        np.testing.assert_array_equal(got[row], want[row], err_msg=what)


def test_hough_lines_equal_reference_on_dense_edges(hough_reference):
    """The 4096 best lines of the dense random edges, in order, bit for
    bit: here the cosines' rounding (taken in float64 and rounded once)
    and the fused multiply-add of x cos + y sin decide votes too."""
    got = _port_lines(hough_reference, "dense", DENSE_EDGES_K)
    want = hough_reference[f"dense_{DENSE_EDGES_K}"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("img", ["step", "board"])
def test_hough_vote_sets(img, hough_reference):
    """The votes of the 16 best lines, sorted, and the (rho, theta) cells
    that carry them, ties included, equal the reference's, run as users
    run it (no x64): under the suite's x64 its thetas are float64 and the
    board's votes are others."""
    got = _port_lines(hough_reference, img, 16)
    want = hough_reference[f"{img}_16"]
    assert sorted(got[2].tolist()) == sorted(want[2].tolist())
    cells = lambda a: set(zip(*a.tolist()))  # noqa: E731
    assert cells(got) == cells(want)


def test_hough_accumulates_repeated_bins():
    """Every edgel of a vertical line at x = 20 lands in one bin of theta =
    0: the accumulator must count all 64 votes (a scatter that overwrites
    would count one)."""
    e = np.zeros((64, 64), bool)
    e[:, 20] = True
    e[5, 40] = True
    rt, tt, vt = ted.hough_lines(torch.from_numpy(e), max_lines=4)
    rj, tj, vj = jed.hough_lines(jnp.asarray(e), max_lines=4)
    assert float(vt.max()) == 64.0 == float(np.max(np.asarray(vj)))
    best = int(torch.argmax(vt))
    assert abs(float(tt[best])) < 1e-6 and abs(float(rt[best]) - 20) < 1.0


def test_hough_detects_vertical_line():
    e = ted.canny(torch.from_numpy(_step(64, 20)))
    rho, theta, votes = ted.hough_lines(e, max_lines=4)
    best = int(torch.argmax(votes))
    th = float(theta[best])
    assert abs(th) < 0.1 or abs(th - np.pi) < 0.1
    assert abs(abs(float(rho[best])) - 19.5) < 3.0
    p0, p1, ok = ted.line_segment_endpoints(e, rho, theta, votes)
    assert bool(ok[best])
    assert float(torch.linalg.norm(p1[best] - p0[best])) > 50
    # The same endpoints as the twin's on the same lines.
    q0, q1, okj = jed.line_segment_endpoints(
        jnp.asarray(e.numpy()), jnp.asarray(rho.numpy()),
        jnp.asarray(theta.numpy()), jnp.asarray(votes.numpy()))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    m = ok.numpy()
    np.testing.assert_allclose(p0.numpy()[m], np.asarray(q0)[m], atol=1e-3)
    np.testing.assert_allclose(p1.numpy()[m], np.asarray(q1)[m], atol=1e-3)


def test_line_segment_endpoints_no_support():
    """A line that no edge pixel lies near: NaN endpoints and ok False, as
    the twin's nanmin gives."""
    e = torch.zeros((32, 32), dtype=torch.bool)
    e[:, 3] = True
    rho = torch.tensor([3.0, 30.0])
    theta = torch.tensor([0.0, 0.0])
    votes = torch.tensor([32.0, 5.0])
    p0, p1, ok = ted.line_segment_endpoints(e, rho, theta, votes)
    assert ok.tolist() == [True, False]
    assert torch.isnan(p0[1]).all() and torch.isfinite(p0[0]).all()


def _chain_sets(chains):
    return sorted(tuple(sorted(map(tuple, np.asarray(c).tolist())))
                  for c in chains)


def _feed_reference_maps(monkeypatch):
    """The port's device program replaced by the reference's: the host
    stages (orientation-consistent components on the native union-find,
    chain walks, RDP, polish) then see the same edge and orientation
    maps."""
    def program(image, low, high, sigma=1.4):
        e, o = jec._edge_orientation_program(jnp.asarray(image.numpy()),
                                             low, high, sigma=sigma)
        return torch.from_numpy(np.asarray(e)), torch.from_numpy(
            np.asarray(o))
    monkeypatch.setattr(tec, "_edge_orientation_program", program)


def _rectangle():
    a = np.zeros((64, 96), np.float32)
    a[20:44, 30:70] = 1.0
    return a


@pytest.mark.parametrize("img", ["square", "rectangle", "board"])
def test_edge_chains_same_point_sets(img, monkeypatch):
    """Stage by stage, the same chains, walked in the same order; end to
    end (where NMS ties may pick the other of two columns) every chained
    edgel of one package within one pixel of a chained edgel of the
    other's."""
    a = {"square": _square, "rectangle": _rectangle, "board": _board}[img]()
    cj = jec.edge_chains(jnp.asarray(a))
    ct = tec.edge_chains(a, device="cpu")

    def chained(chains):
        m = np.zeros(a.shape, bool)
        for c in chains:
            m[c[:, 1].astype(int), c[:, 0].astype(int)] = True
        return m

    mj, mt = chained(cj), chained(ct)
    if img == "board":
        # On the board an NMS tie can also move a chain across the
        # orientation or min_chain thresholds: whole short runs then join
        # or leave. Held here to the chain count within 5% and the
        # chained edgels within 10%; exact stage by stage below.
        assert abs(len(ct) - len(cj)) <= 0.05 * len(cj)
        assert abs(int(mt.sum()) - int(mj.sum())) <= 0.1 * mj.sum()
    else:
        assert mt.any() and _within_one_px(mt, mj) and _within_one_px(mj, mt)
    _feed_reference_maps(monkeypatch)
    ct = tec.edge_chains(a, device="cpu")
    assert _chain_sets(ct) == _chain_sets(cj)
    key = lambda c: tuple(c[0])                               # noqa: E731
    for x, y in zip(sorted(ct, key=key), sorted(cj, key=key)):
        np.testing.assert_array_equal(x, y)


def test_line_segments_match_twin(monkeypatch):
    """Line segments within 0.5 px of the twin's: end to end on the
    rotated square, and stage by stage on the board."""
    params = tec.LineSegmentParams(min_length=15.0)
    jparams = jec.LineSegmentParams(min_length=15.0)
    for name, a in (("square", _square()), ("board", _board())):
        if name == "board":
            _feed_reference_maps(monkeypatch)
        sj = jec.detect_line_segments(jnp.asarray(a), jparams)
        st = tec.detect_line_segments(a, params, device="cpu")
        assert st.shape == sj.shape and len(st) >= 4, (name, st.shape,
                                                       sj.shape)
        for s in st:
            d = np.minimum(np.abs(sj - s).max(axis=(1, 2)),
                           np.abs(sj[:, ::-1] - s).max(axis=(1, 2)))
            assert d.min() < 0.5, name


def test_edge_chains_and_line_segments():
    a = _square()
    chains = tec.edge_chains(a, device="cpu")
    assert len(chains) >= 1 and sum(len(c) for c in chains) > 100
    segs = tec.detect_line_segments(a, tec.LineSegmentParams(min_length=15.0),
                                    device="cpu")
    assert 4 <= len(segs) <= 12, f"{len(segs)} segments"
    d = segs[:, 1] - segs[:, 0]
    ang = np.mod(np.arctan2(d[:, 1], d[:, 0]), np.pi)
    ref = np.array([np.mod(0.3, np.pi), np.mod(0.3 + np.pi / 2, np.pi)])
    err = np.min(np.abs(((ang[:, None] - ref[None]) + np.pi / 2)
                        % np.pi - np.pi / 2), axis=1)
    assert (err < 0.1).all(), f"angles {ang}, errors {err}"
    seg_pair = np.array([[[10.0, 10.0], [50.0, 10.0]],
                         [[55.0, 10.5], [90.0, 10.5]],
                         [[10.0, 60.0], [10.0, 90.0]]])
    labels = tec.group_aligned_segments(seg_pair, dist_threshold=10.0)
    assert labels[0] == labels[1] and labels[2] != labels[0]
    np.testing.assert_array_equal(
        labels, jec.group_aligned_segments(seg_pair, dist_threshold=10.0))


def test_edge_chain_ordering_is_a_path():
    chains = tec.edge_chains(_rectangle(), device="cpu")
    assert chains
    for ch in chains:
        assert (np.abs(np.diff(ch, axis=0)).max(axis=1) <= 1.5).all()


def test_line_segments_on_synthetic_image():
    """The real-image test's synthetic twin: a 240x320 scene of strong
    straight structures (a rotated box, a bar and a triangle on a
    gradient background with noise) gives >= 5 segments, the longest over
    50 px, as the twin's real-image gate asks."""
    h, w = 240, 320
    ys, xs = np.mgrid[0:h, 0:w].astype(float)
    img = 0.2 + 0.3 * xs / w
    c, s = np.cos(0.35), np.sin(0.35)
    xr, yr = c * (xs - 110) + s * (ys - 120), -s * (xs - 110) + c * (ys - 120)
    img[(np.abs(xr) < 60) & (np.abs(yr) < 40)] = 0.9
    img[30:50, 180:300] = 0.05
    img[(ys > 140) & (ys < 220) & (xs > 200) & (xs - 200 < (ys - 140))] = 0.7
    img = (img + np.random.RandomState(0).normal(scale=0.01, size=img.shape)
           ).astype(np.float32)
    segs = tec.detect_line_segments(img, tec.LineSegmentParams(
        min_length=20.0), device="cpu")
    assert len(segs) >= 5
    assert np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1).max() > 50


def test_host_array_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ted.canny(_step())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tec.edge_chains(_square())
