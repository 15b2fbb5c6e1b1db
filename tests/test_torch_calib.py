"""Port parity: ``calib/{chessboard,squares,calibrate,cli}.py``.

The same rendered boards (``tests/test_calibration.py::_render_chessboard``,
240x320, float32) go through the JAX package (on the CPU) and the port
(CPU torch):
- ``_corner_candidates`` stage by stage: the NMS mask bitwise on the
  reference's cornerness, then the candidates as point sets within 1e-3 px,
  then the x-corner mask on the matched candidates;
- ``detect_chessboard_corners``: the same grid within 1e-3 px;
- Zhang's init, the homography pose, one LM step and the full LM in
  float64 at 1e-6; the omnidirectional calibration's xi within 1e-4;
- the squares fallback on a plain and a strongly distorted view
  (``cv2.remap``), as the reference's tests;
- the CLI twin from a foreign cwd on PNGs written by the port's
  ``io/image.py``, against ``scripts/calibrate_camera.py`` within 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.calib import calibrate as jcal
from sara_tpu.calib import chessboard as jcb
from sara_tpu.calib import squares as jsq
from sara_tpu.core import lie as jlie
from sara_tpu.image.differential import harris_cornerness as jax_harris
from sara_tpu_torch.calib import calibrate as tcal
from sara_tpu_torch.calib import chessboard as tcb
from sara_tpu_torch.calib import squares as tsq

ROOT = Path(__file__).resolve().parent.parent
# Time limit (s) of each of the two command-line runs: about three times
# its wall time in the loaded suite, at least 120 s.
CLI_SECONDS = 120
sys.path.insert(0, str(ROOT / "tests"))
from test_calibration import K_GT, _render_chessboard, _view_pose  # noqa


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POSES = {"frontal": (0.05, 0.1, -4.0, -3.0, 10.0),
         "yawed": (0.3, -0.2, -4.0, -3.0, 10.0),
         "steep": (-0.4, 0.3, -4.0, -3.0, 9.0)}


def _board(name, noise=0.0):
    R, t = _view_pose(*POSES[name])
    img, pix, obj = _render_chessboard(K_GT, R, t)
    if noise:
        img = img + np.random.RandomState(0).normal(
            scale=noise, size=img.shape)
    return img.astype(np.float32), pix, obj


def _nms_reference(c, r):
    """The twin's lexicographic NMS rule written out in numpy."""
    H, W = c.shape
    pad = np.pad(c, r, constant_values=-np.inf)
    late = np.full_like(c, -np.inf)
    early = np.full_like(c, -np.inf)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if (dy, dx) == (0, 0):
                continue
            sl = pad[r + dy:r + dy + H, r + dx:r + dx + W]
            if (dy, dx) > (0, 0):
                late = np.maximum(late, sl)
            else:
                early = np.maximum(early, sl)
    return (c > late) & (c >= early) & (c > 0)


@pytest.mark.parametrize("name", sorted(POSES))
def test_nms_mask_bitwise_on_reference_cornerness(name):
    img = _board(name)[0]
    p = jcb.ChessboardParams()
    c = np.asarray(jax_harris(jnp.asarray(img), p.sigma_d, p.sigma_i,
                              p.kappa))
    got = tcb._nms_mask(torch.from_numpy(c), p.nms_radius).numpy()
    np.testing.assert_array_equal(got, _nms_reference(c, p.nms_radius))
    assert got.sum() > 20


def test_nms_mask_keeps_one_of_exact_ties():
    """A plateau of equal maxima keeps exactly one pixel, its
    lexicographically last (no equal neighbour after it); a plain max-pool
    would keep all six."""
    c = np.zeros((20, 24), np.float32)
    c[8:10, 10:13] = 2.0
    c[15, 3] = 1.0
    got = tcb._nms_mask(torch.from_numpy(c), 4).numpy()
    np.testing.assert_array_equal(got, _nms_reference(c, 4))
    assert got.sum() == 2 and got[9, 12] and got[15, 3]


@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", sorted(POSES))
def test_corner_candidates_match_twin(name, noise):
    img = _board(name, noise)[0]
    oj = jcb._corner_candidates(jnp.asarray(img), jcb.ChessboardParams())
    ot = tcb._corner_candidates(torch.from_numpy(img),
                                tcb.ChessboardParams())
    vj = np.isfinite(np.asarray(oj["score"]))
    vt = torch.isfinite(ot["score"]).numpy()
    pj = np.stack([np.asarray(oj["x"]), np.asarray(oj["y"])], 1)[vj]
    pt = np.stack([ot["x"].numpy(), ot["y"].numpy()], 1)[vt]
    assert len(pj) == len(pt) > 30
    d = np.linalg.norm(pj[:, None] - pt[None], axis=-1)
    assert d.min(1).max() < 1e-3 and d.min(0).max() < 1e-3
    # Same candidates -> same x-corner verdicts, matched by position.
    mj = np.asarray(oj["mask"])[vj]
    mt = ot["mask"].numpy()[vt][d.argmin(1)]
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(np.sort(ot["score"].numpy()[vt]),
                               np.sort(np.asarray(oj["score"])[vj]),
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(POSES))
def test_detect_chessboard_corners_match_twin(name):
    img, pix, _ = _board(name)
    gj, okj = jcb.detect_chessboard_corners(img, expected_size=(5, 7))
    gt, okt = tcb.detect_chessboard_corners(img, expected_size=(5, 7),
                                            device="cpu")
    assert okj and okt and gt.shape == gj.shape
    np.testing.assert_allclose(gt, gj, atol=1e-3, rtol=0)
    det = gt.reshape(-1, 2)
    for g in pix.reshape(-1, 2):
        assert np.min(np.linalg.norm(det - g, axis=1)) < 0.5


def _views(noise=0.05, views=((-0.3, 0.2), (0.25, -0.15), (0.1, 0.35),
                              (-0.15, -0.3), (0.4, 0.1))):
    rs = np.random.RandomState(0)
    objs, imgs = [], []
    for yaw, pitch in views:
        R, t = _view_pose(yaw, pitch, -4.0, -3.0, 10.0)
        _, pix, obj = _render_chessboard(K_GT, R, t)
        objs.append(obj.reshape(-1, 2))
        imgs.append(pix.reshape(-1, 2) + rs.normal(scale=noise,
                                                   size=(35, 2)))
    return np.stack(objs), np.stack(imgs)


def test_zhang_init_and_homography_pose():
    O, I = _views(noise=0.0)
    Kj, Hj = jcal.zhang_init_intrinsics(O, I)
    Kt, Ht = tcal.zhang_init_intrinsics(O, I)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-6)
    np.testing.assert_allclose(Ht, Hj, rtol=1e-6, atol=1e-9)
    assert abs(Kt[0, 0] - 300) < 15 and abs(Kt[0, 2] - 160) < 10
    for H in Ht:
        Rj, tj = jcal.homography_pose(Kt, H)
        Rt, tt = tcal.homography_pose(Kt, H)
        np.testing.assert_allclose(Rt, Rj, atol=1e-9)
        np.testing.assert_allclose(tt, tj, atol=1e-9)


def _lm_start(O, I):
    K0, Hs = tcal.zhang_init_intrinsics(O, I)
    poses = []
    for H in Hs:
        R, t = tcal.homography_pose(K0, H)
        poses.append(np.concatenate([np.asarray(jlie.so3_log(
            jnp.asarray(R))), t]))
    intr0 = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0.0])
    obj = np.concatenate([O, np.zeros_like(O[..., :1])], axis=-1)
    return intr0, np.stack(poses), obj


@pytest.mark.parametrize("iters", [1, 30], ids=["one_step", "full_lm"])
@pytest.mark.parametrize("fix", [False, True], ids=["free", "fix_dist"])
def test_refine_float64(iters, fix):
    """One LM step, then the full LM, from the same start, in float64."""
    O, I = _views()
    intr0, poses0, obj = _lm_start(O, I)
    ij, pj, rj = jcal._refine(jnp.asarray(intr0), jnp.asarray(poses0),
                              jnp.asarray(obj), jnp.asarray(I), iters=iters,
                              fix_distortion=fix)
    it, pt, rt = tcal._refine(*(torch.from_numpy(a) for a in
                                (intr0, poses0, obj, I)), iters=iters,
                              fix_distortion=fix)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert abs(float(rt) - float(rj)) < 1e-6
    if fix:
        assert (it.numpy()[4:] == 0).all()


def test_calibrate_pinhole_matches_twin():
    O, I = _views()
    oj = jcal.calibrate_pinhole(O, I)
    ot = tcal.calibrate_pinhole(O, I, device="cpu")
    np.testing.assert_allclose(ot["K"], oj["K"], rtol=1e-6)
    np.testing.assert_allclose(ot["dist"], oj["dist"], atol=1e-6)
    np.testing.assert_allclose(ot["poses"], oj["poses"], atol=1e-6)
    assert abs(ot["rms"] - oj["rms"]) < 1e-6 and ot["rms"] < 0.2
    assert abs(ot["K"][0, 0] - 300) < 3 and abs(ot["K"][1, 2] - 120) < 3


def test_calibrate_pinhole_float32_dtype_rule():
    """float32 points run the LM in float32 (the twin's production
    dtype): K within 1e-3 relative of the float64 run."""
    O, I = _views()
    o64 = tcal.calibrate_pinhole(O, I, device="cpu")
    o32 = tcal.calibrate_pinhole(O.astype(np.float32), I.astype(np.float32),
                                 device="cpu")
    assert o32["poses"].dtype == np.float32
    np.testing.assert_allclose(o32["K"], o64["K"], rtol=1e-3)
    assert abs(o32["rms"] - o64["rms"]) < 1e-3


def _omni_views(xi=0.6):
    intr = torch.tensor([480.0, 480.0, 160.0, 120.0, 0.0, 0.0, xi],
                        dtype=torch.float64)
    views = [(-0.4, 0.3), (0.35, -0.25), (0.15, 0.45), (-0.25, -0.4),
             (0.45, 0.2)]
    jj, ii = np.meshgrid(np.arange(1, 10), np.arange(1, 8))
    obj = np.stack([jj, ii], axis=-1).reshape(-1, 2).astype(float) * 1.5
    X = torch.from_numpy(np.concatenate([obj, np.zeros((len(obj), 1))], 1))
    objs, imgs = [], []
    for yaw, pitch in views:
        R, t = _view_pose(yaw, pitch, -7.0, -5.0, 5.0)
        w = np.asarray(jlie.so3_log(jnp.asarray(R)))
        p6 = torch.from_numpy(np.concatenate([w, t]))[None]
        imgs.append(tcal._project_omni(intr, p6, X[None])[0].numpy())
        objs.append(obj)
    return np.stack(objs), np.stack(imgs), obj


def test_project_omni_matches_twin():
    O, I, obj = _omni_views()
    intr = jnp.asarray([480.0, 480.0, 160.0, 120.0, 0.0, 0.0, 0.6])
    R, t = _view_pose(-0.4, 0.3, -7.0, -5.0, 5.0)
    p6 = jnp.asarray(np.concatenate([np.asarray(jlie.so3_log(
        jnp.asarray(R))), t]))
    want = np.stack([np.asarray(jcal._project_omni(
        intr, p6, jnp.asarray([X, Y, 0.0]))) for X, Y in obj])
    np.testing.assert_allclose(I[0], want, atol=1e-9)


def test_calibrate_omnidirectional_matches_twin():
    O, I, _ = _omni_views()
    oj = jcal.calibrate_omnidirectional(O, I)
    ot = tcal.calibrate_omnidirectional(O, I, device="cpu")
    assert abs(ot["xi"] - oj["xi"]) < 1e-4
    assert abs(ot["xi"] - 0.6) < 0.1 and ot["rms"] < 0.1
    np.testing.assert_allclose(ot["K"], oj["K"], rtol=1e-4)
    assert abs(ot["K"][0, 0] - 480.0) < 25.0


def _candidates(img):
    out = tcb._corner_candidates(torch.from_numpy(img),
                                 tcb.ChessboardParams())
    m = out["mask"].numpy()
    return np.stack([out["x"].numpy()[m], out["y"].numpy()[m]], axis=1)


def test_square_reconstruction_grid_pinhole():
    ang = 0.25
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    img, pix_gt, _ = _render_chessboard(K_GT, R, np.array([-4.0, -3.0,
                                                           10.0]))
    img = img.astype(np.float32)
    pts = _candidates(img)
    grid = tsq.assemble_grid_from_squares(img, pts, device="cpu")
    assert grid is not None and sorted(grid.shape[:2]) == [5, 7]
    det = grid.reshape(-1, 2)
    for g in pix_gt.reshape(-1, 2):
        assert np.min(np.linalg.norm(det - g, axis=1)) < 0.7
    # The same squares and grid as the twin's from the same corners.
    gj = jsq.assemble_grid_from_squares(img, pts)
    np.testing.assert_allclose(grid, gj, atol=1e-9)


def _barrel(img, k1=-0.30, f=200.0):
    import cv2

    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xs - cx) / f) ** 2 + ((ys - cy) / f) ** 2
    mx = (cx + (xs - cx) * (1 + k1 * r2)).astype(np.float32)
    my = (cy + (ys - cy) * (1 + k1 * r2)).astype(np.float32)
    out = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REPLICATE)

    def fwd(p):
        q = p.copy()
        for _ in range(20):
            n = (q - [cx, cy]) / f
            q = [cx, cy] + (p - [cx, cy]) / (1 + k1 * (n * n).sum())
        return q
    return out, fwd


def test_square_reconstruction_grid_distorted():
    ang = 0.2
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    img, pix_gt, _ = _render_chessboard(K_GT, R, np.array([-4.0, -3.0, 9.0]))
    dimg, fwd = _barrel(img.astype(np.float32))
    gt_d = np.stack([fwd(p) for p in pix_gt.reshape(-1, 2)])
    pts = _candidates(dimg)
    grid = tsq.assemble_grid_from_squares(dimg, pts, device="cpu")
    assert grid is not None and sorted(grid.shape[:2]) == [5, 7]
    det = grid.reshape(-1, 2)
    for g in gt_d:
        assert np.min(np.linalg.norm(det - g, axis=1)) < 1.0
    # Through the detector's fallback too (the lattice BFS fails here).
    gd, ok = tcb.detect_chessboard_corners(dimg, expected_size=(5, 7),
                                           device="cpu")
    assert ok and sorted(gd.shape[:2]) == [5, 7]


def _write_frames(tmp_path, n=6):
    from sara_tpu_torch.io.image import imwrite

    d = tmp_path / "frames"
    d.mkdir()
    rs = np.random.RandomState(2)
    for k in range(n):
        yaw, pitch = rs.uniform(-0.35, 0.35, 2)
        R, t = _view_pose(yaw, pitch, -4.0, -3.0, 10.0)
        img = _render_chessboard(K_GT, R, t)[0]
        imwrite(str(d / f"f{k:02d}.png"), img)
    return str(d / "*.png")


def test_cli_matches_reference_script(tmp_path):
    """The CLI twin from a foreign cwd on PNGs written by the port's
    ``io/image.py``: the same JSON as the reference's script (run with
    float64 enabled, as its tests run) within 1e-4."""
    pattern = _write_frames(tmp_path)
    cwd = tmp_path / "elsewhere"
    cwd.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1", OMP_NUM_THREADS="1")
    common = ["--images", pattern, "--rows", "5", "--cols", "7",
              "--square-size", "0.5"]
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "calibrate_camera.py"),
         *common, "-o", str(tmp_path / "ref.json")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=CLI_SECONDS)
    assert ref.returncode == 0, ref.stderr[-2000:]
    port = subprocess.run(
        [sys.executable, "-m", "sara_tpu_torch.calib.cli", *common,
         "--device", "cpu", "-o", str(tmp_path / "port.json")], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=CLI_SECONDS)
    assert port.returncode == 0, port.stderr[-2000:]
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "port.json").read_text())
    assert json.loads(port.stdout.strip().splitlines()[-1]) == b
    assert set(a) == set(b) and a["model"] == b["model"] == "pinhole"
    assert a["num_views"] == b["num_views"] == 6
    np.testing.assert_allclose(b["K"], a["K"], rtol=1e-4)
    np.testing.assert_allclose(b["dist"], a["dist"], atol=1e-4)
    assert abs(b["rms"] - a["rms"]) < 1e-4 and b["rms"] < 0.5
    assert abs(b["K"][0][0] - 300.0) < 5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = _board("frontal")[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb.detect_chessboard_corners(img)
    O, I = _views()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.calibrate_pinhole(O, I)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcal.calibrate_omnidirectional(O, I)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsq.assemble_grid_from_squares(img, np.zeros((4, 2)))
