"""The bench twin ``torch_bench.py`` held against ``bench.py`` on the CPU.

Both run in this process at a small size: the seeded noise pair of
``bench.py:55-62`` at 96x128 (no photographs here) and capacity 512, with
the module constants ``TOTAL_CAP``, ``ITERS`` and the twin's ``load_pair``
monkeypatched. ``bench.bench_ours`` runs under the suite's x64, where
``compute_sift_keypoints`` gives the same keypoints bit for bit as without
it (ROADMAP §3).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import torch_bench as tb  # noqa: E402

HW = (96, 128)
CAP = 512
# Keypoint and match counts: the twin within 1% of bench.py's.
COUNT_REL = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def small(mp, modules=(tb,)):
    """``modules`` cut to capacity ``CAP`` and one timed pair, the twin's
    pair to ``HW``."""
    full = tb.load_pair
    for mod in modules:
        mp.setattr(mod, "TOTAL_CAP", CAP)
        mp.setattr(mod, "ITERS", 1)
    mp.setattr(tb, "load_pair", lambda: full(*HW))
    yield


def run_main(no_cv2: bool):
    """The twin's ``main(["--device", "cpu"])`` at the small size: its
    standard output, its result and what ``bench_ours`` recorded. With
    ``no_cv2``, cv2 is unimportable and the throughput run (which does not
    read cv2) is stubbed."""
    printed = io.StringIO()
    record = {}
    with pytest.MonkeyPatch.context() as mp, small(mp):
        if no_cv2:
            mp.setitem(sys.modules, "cv2", None)
            mp.setattr(tb, "bench_ours",
                       lambda a, b, device, record: (2.0, 57, 51))
        with contextlib.redirect_stdout(printed):
            res = tb.main(["--device", "cpu"], record=record)
    return printed.getvalue(), res, record


@pytest.fixture(scope="module")
def twin_run():
    return run_main(no_cv2=False)


@pytest.fixture(scope="module")
def twin_run_no_cv2():
    return run_main(no_cv2=True)


def bench_keys(monkeypatch, capsys) -> list:
    """The keys of ``bench.main``'s line, in order: ``bench.main`` with its
    throughput, OpenCV and detector runs stubbed (the JAX quality tool's
    ``run_ours`` / ``run_opencv`` return fixed keypoints), its quality and
    roofline code as they are."""
    path = ROOT / "scripts" / "eval_detection_quality.py"
    spec = importlib.util.spec_from_file_location("eval_detection_quality",
                                                  path)
    q = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(q)
    xy = np.random.RandomState(0).uniform(20, 100, (40, 2))
    run = (xy, xy + 1.0, np.stack([np.arange(40)] * 2, axis=1), 0.1)
    monkeypatch.setattr(q, "run_ours", lambda *a, **k: run)
    monkeypatch.setattr(q, "run_opencv", lambda *a, **k: run)
    monkeypatch.setitem(sys.modules, "eval_detection_quality", q)
    monkeypatch.setattr(bench, "bench_ours", lambda a, b: (10.0, 40, 40))
    monkeypatch.setattr(bench, "bench_opencv", lambda a, b: 5.0)
    monkeypatch.setattr(bench, "load_pair", lambda: tb.load_pair(*HW))
    capsys.readouterr()
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return list(json.loads(lines[0]))


def test_load_pair_is_bench_pair():
    """Without the photographs both load the same seeded noise pair."""
    for got, want in zip(tb.load_pair(*HW), bench.load_pair(*HW)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bench_ours_counts_match_bench(twin_run, monkeypatch):
    """``bench_ours`` on the same seeded 96x128 pair at capacity 512 (the
    twin's through its ``main``): the twin's keypoints of frame A and its
    matches within 1% of ``bench.bench_ours``'s, and its pipelined counts
    those of its first batch."""
    a, b = bench.load_pair(*HW)
    with small(monkeypatch, (bench,)):
        _, n_a, n_m = bench.bench_ours(a, b)
    last = twin_run[2]
    t_a, t_m = last["keypoints"][0], last["matches"]
    assert n_a > 20 and n_m > 20
    assert abs(t_a - n_a) <= COUNT_REL * n_a
    assert abs(t_m - n_m) <= COUNT_REL * n_m
    assert last["pipelined_counts"] == [last["first_counts"]]
    assert abs(last["first_counts"] - t_m) <= COUNT_REL * t_m
    assert not any(last["sampler_launches"].values())
    assert np.isfinite(twin_run[1]["value"]) and twin_run[1]["value"] > 0


def test_main_prints_one_line_with_bench_keys(twin_run, monkeypatch,
                                              capsys):
    """``main`` prints one line on stdout: a JSON object with
    ``bench.py``'s keys in its order, its metric and unit."""
    printed, res, _ = twin_run
    lines = printed.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == res
    assert list(line) == bench_keys(monkeypatch, capsys)
    assert line["metric"] == "two_view_sift_detect_describe_match_throughput"
    assert line["unit"] == "frames/s"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["quality_scenes"] == 1
    assert all(isinstance(line[k], float) for k in tb.OPENCV_KEYS)


def test_no_opencv_gives_null_ratios(twin_run_no_cv2):
    """With cv2 unimportable (the card's machine): no baseline, so
    ``vs_baseline`` and the OpenCV ratios are null, never 1.0; the port's
    own repeatability is still measured (on the zero-filled warp)."""
    printed, res, _ = twin_run_no_cv2
    assert json.loads(printed) == res
    for key in ("vs_baseline",) + tb.OPENCV_KEYS:
        assert res[key] is None, key
    assert 0.0 < res["repeatability"] <= 1.0


def test_roofline_keys_are_the_estimate_over_the_time(twin_run):
    """The roofline keys: the port's ``sift_frame`` at capacity 512 plus
    half of ``match_pair``'s GEMM at the H100's peaks, against one frame's
    time, 1 / (frames/s). ``main``'s line carries them for its own rate;
    the fraction is checked at a rate where it is not rounded to 0."""
    from sara_tpu_torch.utils.roofline import (PEAK_F32_FLOPS, PEAK_HBM_BW,
                                               match_pair, sift_frame)

    _, res, _ = twin_run
    s = sift_frame(*HW, first_octave=-1, keypoints=CAP)
    m = match_pair(CAP, CAP)
    flops, nbytes = s.flops + 0.5 * m.flops, s.bytes + 0.5 * m.bytes
    roof_s = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BW)
    bound = ("compute" if flops / PEAK_F32_FLOPS > nbytes / PEAK_HBM_BW
             else "memory")
    assert res["frame_gflop"] == round(flops / 1e9, 2)
    assert res["frame_mb"] == round(nbytes / 1e6, 1)
    assert res["roofline_bound"] == bound
    assert res["roofline_frac"] == round(roof_s * res["value"], 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "TOTAL_CAP", CAP)
        fast = tb.roofline(5000.0, *HW)
    assert fast["roofline_frac"] == round(roof_s * 5000.0, 4) > 0.01


def test_batch_of_two_is_one_batched_pass_with_batch_one_counts(twin_run,
                                                               monkeypatch):
    """``SARA_BENCH_BATCH`` = 2: each batch is one batched pass
    (``_compute_sift_batch`` once per side, one ``_match_sets`` over the
    pair axis, the per-pair entry points never called), and each pair's
    match count equals batch 1's on the same pair (the batch's two pairs
    differ only by bench.py's 1e-4 noise, within 1%)."""
    import sara_tpu_torch.features.api as api

    calls = []
    batch = api._compute_sift_batch

    def counted(images, *args, **kwargs):
        calls.append(tuple(images.shape))
        return batch(images, *args, **kwargs)

    record = {}
    a, b = tb.load_pair(*HW)
    with small(monkeypatch):
        monkeypatch.setattr(tb, "BATCH", 2)
        monkeypatch.setattr(api, "_compute_sift_batch", counted)
        tb.bench_ours(a, b, device="cpu", record=record)
    one = twin_run[2]
    assert record["batch"] == 2 and one["batch"] == 1
    # The warm-up pair goes through compute_sift_keypoints (its B = 1
    # case), then two batched passes per batch: the first and one timed.
    assert calls.count((1,) + HW) == 2
    assert calls.count((2,) + HW) == 4
    assert record["keypoints"] == one["keypoints"]
    assert record["matches"] == one["matches"]
    assert len(record["first_counts"]) == 2
    assert record["pipelined_counts"] == [record["first_counts"]]
    for count in record["first_counts"]:
        assert abs(count - one["first_counts"]) <= COUNT_REL * one[
            "first_counts"]
    assert not any(record["sampler_launches"].values())
