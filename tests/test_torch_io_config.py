"""Port parity: ``io/{image,video}.py``, ``config.py``, ``utils/{timing,
clustering,admm}.py`` and ``convert.params_from_jax`` for Slice E's
parameter types.

The readers are PIL and cv2 code shared in kind with the twin; each round
trip is checked here (the machine with the card has neither library). The
configuration's JSON is held equal to the twin's field for field, with the
one documented deviation (``SIFTParams.low_precision`` defaults to False in
the port).
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu import config as jconfig
from sara_tpu.calib.chessboard import ChessboardParams as JaxChessboard
from sara_tpu.image.edge_chains import LineSegmentParams as JaxLineSegment
from sara_tpu.io import image as jimage
from sara_tpu.utils import admm as jadmm
from sara_tpu.utils import clustering as jclust
from sara_tpu_torch import config as tconfig
from sara_tpu_torch.convert import params_from_jax
from sara_tpu_torch.io import image as timage
from sara_tpu_torch.io import video as tvideo
from sara_tpu_torch.utils import admm as tadmm
from sara_tpu_torch.utils import clustering as tclust
from sara_tpu_torch.utils import timing


@pytest.mark.parametrize("ext", ["png", "tiff"])
def test_image_round_trip(tmp_path, ext):
    rs = np.random.RandomState(0)
    rgb = rs.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    path = str(tmp_path / f"a.{ext}")
    timage.imwrite(path, rgb)
    np.testing.assert_array_equal(timage.imread(path), rgb)
    np.testing.assert_array_equal(timage.imread(path), jimage.imread(path))
    g = rs.rand(20, 28).astype(np.float32)
    gpath = str(tmp_path / f"g.{ext}")
    timage.imwrite(gpath, g)
    got = timage.imread_gray(gpath)
    assert got.dtype == np.float32 and got.shape == g.shape
    np.testing.assert_allclose(got, g, atol=1 / 255 + 1e-6)
    np.testing.assert_array_equal(got, jimage.imread_gray(gpath))
    np.testing.assert_array_equal(timage.imread_gray(gpath, scale=0.5),
                                  jimage.imread_gray(gpath, scale=0.5))
    assert timage.supported_formats() == jimage.supported_formats()


def test_video_round_trip(tmp_path):
    """Frames written by VideoWriter come back from VideoStream (lossy
    mp4v, so within a codec's error), with frame skipping."""
    pytest.importorskip("cv2")
    path = str(tmp_path / "v.mp4")
    w = tvideo.VideoWriter(path, (48, 64), fps=10.0)
    frames = []
    for k in range(6):
        f = np.zeros((48, 64, 3), np.uint8)
        f[:, :, k % 3] = 40 * (k + 1)
        frames.append(f)
        w.write(f)
    w.close()
    s = tvideo.VideoStream(path)
    assert s.sizes == (48, 64) and abs(s.fps - 10.0) < 1e-6
    got = list(s)
    s.close()
    assert len(got) == 6
    for a, b in zip(got, frames):
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 8
    s = tvideo.VideoStream(path, num_skips=1)
    skipped = list(s)
    s.close()
    assert len(skipped) == 3 and s.frame_index == 5


def test_pipeline_config_json_matches_twin():
    """The port's JSON equals the twin's field for field (the port's
    low_precision default aside), and each package reads the other's."""
    tj = json.loads(tconfig.PipelineConfig().to_json())
    jj = json.loads(jconfig.PipelineConfig().to_json())
    assert tj["odometry"]["sift"].pop("low_precision") is False
    assert jj["odometry"]["sift"].pop("low_precision") is True
    assert tj == jj
    cam = tconfig.CameraConfig(fx=512.0, k1=-0.1)
    cfg = tconfig.PipelineConfig(camera=cam, match_ratio=0.7,
                                 sift_total_capacity=2048)
    back = tconfig.PipelineConfig.from_json(cfg.to_json())
    assert back == cfg
    from_twin = tconfig.PipelineConfig.from_json(
        jconfig.PipelineConfig(match_ratio=0.7).to_json())
    assert from_twin.match_ratio == 0.7
    assert from_twin.odometry.ba_options == cfg.odometry.ba_options
    assert jconfig.PipelineConfig.from_json(cfg.to_json()).camera.fx == 512.0
    np.testing.assert_array_equal(cam.K(), jconfig.CameraConfig(
        fx=512.0, k1=-0.1).K())
    assert cam.has_distortion() and not tconfig.CameraConfig().has_distortion()
    assert cfg.sift_params().total_capacity == 2048
    assert cfg.match_params().ratio == 0.7


@pytest.mark.parametrize("make", [
    lambda: JaxChessboard(capacity=256, nms_radius=3, sigma_i=2.0),
    lambda: JaxLineSegment(min_chain=3, angular_threshold_deg=30.0),
    lambda: jconfig.CameraConfig(fx=512.0, cy=200.0, p2=0.01),
    lambda: jconfig.PipelineConfig(match_ratio=0.7, sift_total_capacity=2048),
], ids=["ChessboardParams", "LineSegmentParams", "CameraConfig",
        "PipelineConfig"])
def test_params_from_jax_slice_e(make):
    j = make()
    t = params_from_jax(j)
    assert type(t).__name__ == type(j).__name__
    assert type(t).__module__.startswith("sara_tpu_torch.")
    want = dataclasses.asdict(j)
    got = dataclasses.asdict(t)
    if type(j).__name__ == "PipelineConfig":
        # The twin's SIFTParams.low_precision takes effect only on a TPU.
        assert want["odometry"]["sift"].pop("low_precision") is True
        assert got["odometry"]["sift"].pop("low_precision") is False
        assert type(t.ba).__module__ == "sara_tpu_torch.ba.core"
    assert got == want
    assert params_from_jax(t) == t


def test_timer_and_tictoc():
    t = timing.Timer()
    assert 0 <= t.elapsed() and t.elapsed_ms() >= 0
    tt = timing.TicToc()
    for _ in range(3):
        tt.tic("a")
        tt.toc("a")
    assert tt.counts["a"] == 3 and "a: total" in tt.report()


def test_device_trace_runs_and_writes(tmp_path):
    """On the CPU the trace records the CPU side and writes its file; the
    body runs either way."""
    ran = []
    with timing.device_trace(str(tmp_path / "trace")) as tr:
        torch.ones(8).sum()
        ran.append(1)
    assert ran == [1] and isinstance(tr, timing.device_trace)
    assert (tmp_path / "trace" / "trace.json").exists()


def test_device_trace_is_a_no_op_where_no_profiler_starts(monkeypatch,
                                                          tmp_path):
    import torch.profiler as tp

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", broken)
    with timing.device_trace(str(tmp_path / "none")):
        pass
    assert not (tmp_path / "none").exists()


def test_event_timer_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        timing.EventTimer().start()


@pytest.mark.parametrize("gap", [0.3, 1.0, 5.0])
def test_cluster_1d(gap):
    v = np.random.RandomState(1).rand(40) * 10
    lt, ct = tclust.cluster_1d(v, gap)
    lj, cj = jclust.cluster_1d(v, gap)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ct, cj)
    assert tclust.cluster_1d(np.zeros(0), 1.0)[0].shape == (0,)


@pytest.mark.parametrize("lam", [0.05, 0.5])
def test_lasso_matches_twin(lam):
    rs = np.random.RandomState(2)
    A = rs.randn(30, 12)
    x = np.zeros(12)
    x[[1, 5, 9]] = [1.5, -2.0, 0.7]
    b = A @ x + 0.01 * rs.randn(30)
    zj = np.asarray(jadmm.lasso(jnp.asarray(A), jnp.asarray(b), lam))
    zt = tadmm.lasso(torch.from_numpy(A), torch.from_numpy(b), lam)
    assert zt.dtype == torch.float64
    np.testing.assert_allclose(zt.numpy(), zj, atol=1e-9)
    assert np.abs(zt.numpy() - x).max() < 0.1


def test_admm_matches_twin():
    """The generic scaled-form ADMM on the lasso split x - z = 0 (A = I, B
    = -I, c = 0), with the twin's proximal operators written in each
    package."""
    rs = np.random.RandomState(3)
    M = rs.randn(20, 6)
    b = rs.randn(20)
    lam, rho = 0.3, 1.0
    P = np.linalg.inv(M.T @ M + rho * np.eye(6))
    Mtb = M.T @ b

    def run(xp, mod, asarr):
        prox_f = lambda v, r: asarr(P) @ (asarr(Mtb) + r * v)    # noqa
        prox_g = lambda v, r: -xp.sign(-v) * xp.maximum(          # noqa
            xp.abs(v) - lam / r, 0 * v)
        eye = asarr(np.eye(6))
        return mod.admm(prox_f, prox_g, eye, -eye, asarr(np.zeros(6)),
                        asarr(np.zeros(6)), asarr(np.zeros(6)), rho=rho,
                        iters=50)

    sj = run(jnp, jadmm, jnp.asarray)
    st = run(torch, tadmm, torch.from_numpy)
    for a, b_ in zip(sj, st):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), atol=1e-9)
