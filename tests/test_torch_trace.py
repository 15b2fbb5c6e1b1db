"""The port's recorder of spans and counters (``utils/timing.py::trace``)
and its callers: the SIFT frontend, the matcher and the PCG bundle
adjuster.

The recorder keeps something only while a ``torch.profiler`` session
collects. Checked here on the CPU: off it keeps nothing; on it nests
spans, subtracts child time and reduces counters in ``summary()``; each
caller records the spans and counts its docstring names; the outputs are
bit for bit the same with the recorder on and off; ``device_trace`` writes
``spans.json`` with the device's idle gaps named by program spans.
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sara_tpu_torch.ba import core
from sara_tpu_torch.features import api
from sara_tpu_torch.features.dog import DoGParams
from sara_tpu_torch.matching import brute_force
from sara_tpu_torch.utils import timing
from sara_tpu_torch.utils.timing import trace

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "tests"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chip_smoke import vo_frames  # noqa: E402
from tool_twins import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.clear()
    yield
    trace.clear()


def recorded(fn):
    """(fn's result, the recorder's summary) with the recorder on."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.summary()


def same(a, b):
    return all(x is y is None or torch.equal(x, y) for x, y in zip(a, b))


def test_off_keeps_nothing():
    assert trace.span("a") is trace.span("b")
    with trace.span("a", 3):
        trace.count("n", 2)
        trace.count("t", torch.ones(4, dtype=torch.bool))
    assert trace.summary() == {"spans": {}, "counts": {}}


def test_on_nests_subtracts_and_reduces():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer", 2):
            time.sleep(0.01)
            for _ in range(2):
                with trace.span("inner"):
                    time.sleep(0.01)
            trace.count("n", 3)
            trace.count("t", torch.tensor([True, False, True]))
            trace.count("f", lambda: torch.full((2,), 1.5))
    with trace.span("late"):
        trace.count("n", 100)
    got = trace.summary()
    outer, inner = got["spans"]["outer"], got["spans"]["inner"]
    assert set(got["spans"]) == {"outer", "inner"}
    assert (outer["calls"], outer["units"]) == (1, 2.0)
    assert (inner["calls"], inner["units"]) == (2, 2.0)
    assert outer["device_ms"] is None and inner["device_ms"] is None
    assert outer["host_s"] >= inner["host_s"] + 0.01
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_s"] == inner["host_s"]
    ids = {s.name: s for s in trace._spans}
    assert ids["outer"].parent is None
    assert all(s.parent == ids["outer"].id for s in trace._spans
               if s.name == "inner")
    assert got["counts"] == {"n": 3, "t": 2, "f": 3.0}


@pytest.mark.parametrize("value, want", [
    (3, 3),
    (2.5, 2.5),
    (torch.tensor([True, False, True]), 2),
    (torch.arange(4), 6),
    (lambda: torch.full((3,), 2.0), 6.0),
    (lambda: 7, 7),
], ids=["int", "float", "bool_tensor", "int_tensor", "callable_tensor",
        "callable_int"])
def test_counter_reduces_each_kind(value, want):
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("c", value)
        trace.count("c", value)
    assert trace.summary()["counts"] == {"c": 2 * want}


def test_clear_forgets_spans_and_counts():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            trace.count("n", 1)
    assert trace.summary()["spans"]["a"]["calls"] == 1
    trace.clear()
    assert trace.summary() == {"spans": {}, "counts": {}}


def test_span_closes_when_its_body_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("x")
        with trace.span("next"):
            pass
    assert trace._stack() == []
    spans = {s.name: s for s in trace._spans}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["next"].parent is None


def test_each_thread_has_its_own_parents():
    """A span open on one thread is no parent of a span on another."""
    import threading

    seen = []

    def work():
        seen.append(list(trace._stack()))
        with trace.span("worker"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
            assert [s.name for s in trace._stack()] == ["main"]
    assert seen == [[]]
    assert trace._stack() == []
    assert all(s.parent is None for s in trace._spans)
    assert "main" in trace.summary()["spans"]


def test_sift_spans_and_counts():
    _, imgs, _ = vo_frames(2, hw=(48, 64))
    params = api.SIFTParams(dog=DoGParams(capacity=256, refine_iters=2),
                            total_capacity=384)
    run = lambda: api._compute_sift_batch(np.stack(imgs), params,  # noqa
                                          device="cpu")
    off = run()
    on, got = recorded(run)
    assert same(off, on)
    spans, counts = got["spans"], got["counts"]
    octaves = sorted(k for k in counts if k.startswith("sift.valid.o"))
    n = len(octaves)
    assert n >= 3 and octaves[0] == "sift.valid.o0"
    assert spans["sift"]["units"] == 2 and spans["sift"]["calls"] == 1
    assert spans["sift.pyramid"]["calls"] == spans["sift.merge"]["calls"] == 1
    for stage in ("detect", "orient", "compact", "describe"):
        assert spans[f"sift.{stage}"]["calls"] == n
    assert counts["sift.kept"] == int(on.mask.sum())
    assert counts["sift.kept"] <= sum(counts[k] for k in octaves)
    assert sum(counts[k] for k in octaves) <= counts["sift.desc_rows"]


def test_match_counts_by_hand():
    g = torch.Generator().manual_seed(3)
    da = torch.randn(3, 5, 8, generator=g)
    db = torch.randn(3, 6, 8, generator=g)
    ma = torch.zeros(3, 5, dtype=torch.bool)
    mb = torch.zeros(3, 6, dtype=torch.bool)
    ma[0], mb[0, :4] = True, True        # 5 x 4
    ma[1, :2], mb[1, 3:] = True, True    # 2 x 3; pair 2 is padded: 0 x 0
    run = lambda: brute_force._match_sets(da, ma, db, mb, 0.8)  # noqa
    off = run()
    on, got = recorded(run)
    assert same(off, on)
    assert got["spans"]["match"]["units"] == 3
    assert got["counts"] == {"match.cells": 3 * 5 * 6,
                             "match.cells_valid": 5 * 4 + 2 * 3}


def tiny_ba_problem(C=4, P=60):
    g = torch.Generator().manual_seed(5)
    f64 = torch.float64
    X = torch.rand(P, 3, generator=g, dtype=f64) * 4 - 2
    X[:, 2] += 8
    poses = torch.zeros(C, 6, dtype=f64)
    poses[:, 3] = torch.linspace(0, 1, C, dtype=f64)
    cam = torch.arange(C).repeat_interleave(P)
    pt = torch.arange(P).repeat(C)
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0], dtype=f64)
    Xc = X[pt] + poses[cam, 3:]
    uv = intr[:2] * Xc[:, :2] / Xc[:, 2:] + intr[2:]
    uv = uv + 0.3 * torch.randn(uv.shape, generator=g, dtype=f64)
    return core.BAProblem(
        poses=poses + 1e-3 * torch.randn(C, 6, generator=g, dtype=f64),
        points=X + 0.02 * torch.randn(P, 3, generator=g, dtype=f64),
        intrinsics=intr, cam_idx=cam, pt_idx=pt, uv=uv,
        obs_mask=torch.ones(C * P, dtype=torch.bool),
        pose_fixed=torch.arange(C) == 0,
        point_fixed=torch.zeros(P, dtype=torch.bool))


def test_lm_cg_spans_and_counts():
    p = tiny_ba_problem()
    opts = core.BAOptions(max_iters=3, solver="cg", cg_iters=5)
    run = lambda: core._lm_cg(p, opts)  # noqa: E731
    off = run()
    on, got = recorded(run)
    assert same(off[0], on[0])
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    spans, counts = got["spans"], got["counts"]
    assert spans["ba.lm"]["units"] == 3 and spans["ba.lm"]["calls"] == 1
    for stage in ("jacobians", "blocks", "pcg", "backsub", "cost"):
        assert spans[f"ba.{stage}"]["calls"] == 3
    assert counts["ba.iterations"] == 3
    assert 1 <= counts["ba.accepted"] <= counts["ba.iterations"]


def test_device_trace_writes_spans_and_gaps(tmp_path):
    with timing.device_trace(str(tmp_path)) as tr:
        with trace.span("work"):
            torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "spans.json").read_text())
    assert data == json.loads(json.dumps(tr.spans))
    assert data["spans"]["work"]["calls"] == 1
    assert set(data["device"]) == {"busy_s", "window_s", "idle_s"}

    def ev(name, a, b, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a, end=b))
    events = [ev("k", 0, 10), ev("k", 20, 30), ev("k", 50, 60),
              ev("a", 5, 25, DeviceType.CPU), ev("b", 0, 100, DeviceType.CPU),
              ev("a", 0, 60), ev("cpu_op", 30, 50, DeviceType.CPU)]
    got = timing.idle_gaps(events, {"a", "b"})
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["window_s"] == pytest.approx(60e-6)
    assert got["idle_s"] == pytest.approx({"b": 20e-6, "a": 10e-6})
    assert timing.idle_gaps(events[:1], set())["idle_s"] == {}


def _ev(name, a, b, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


@pytest.mark.parametrize("events, spans, want", [
    ([], set(), (0.0, 0.0, {})),
    ([_ev("k", 0, 10), _ev("k", 5, 20), _ev("k", 20, 30)], set(),
     (30e-6, 30e-6, {})),
    ([_ev("k", 0, 10), _ev("k", 40, 50)], {"a"},
     (20e-6, 50e-6, {"host": 30e-6})),
    ([_ev("k", 0, 10), _ev("k", 40, 50), _ev("a", 0, 20, DeviceType.CPU)],
     {"a"}, (20e-6, 50e-6, {"host": 30e-6})),
    ([_ev("k", 0, 10), _ev("k", 12, 14), _ev("k", 40, 50),
      _ev("a", 0, 100, DeviceType.CPU), _ev("b", 20, 35, DeviceType.CPU)],
     {"a", "b"}, (22e-6, 50e-6, {"b": 26e-6, "a": 2e-6})),
], ids=["empty", "overlapping_kernels_merge", "gap_outside_spans",
        "span_misses_the_midpoint", "innermost_span_names_the_gap"])
def test_idle_gaps_cases(events, spans, want):
    got = timing.idle_gaps(events, spans)
    busy, window, idle = want
    assert got["busy_s"] == pytest.approx(busy)
    assert got["window_s"] == pytest.approx(window)
    assert got["idle_s"] == pytest.approx(idle)
    assert list(got["idle_s"]) == sorted(idle, key=lambda k: -idle[k])
