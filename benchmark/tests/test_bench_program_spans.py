"""The readers of the program's own spans and counters: None where the
recorder saw nothing (or the program has no recorder), and the value
worked out by hand from a made-up summary."""

from __future__ import annotations

import pytest

from benchmark import run

NEW = ("sift_pyramid_ms_per_frame.seq8", "sift_desc_useful.seq8",
       "sift_issue_ms_per_frame.stereo", "match_cells_useful.exh",
       "ba_pcg_ms_per_iter.cg", "ba_linearize_ms_per_iter.cg")

SUMMARY = {
    "spans": {
        "sift": {"calls": 4, "host_s": 2.0, "self_s": 0.1,
                 "device_ms": 1600.0, "units": 32.0},
        "sift.pyramid": {"calls": 4, "host_s": 0.5, "self_s": 0.5,
                         "device_ms": 800.0, "units": 32.0},
        "ba.pcg": {"calls": 10, "host_s": 0.3, "self_s": 0.3,
                   "device_ms": 900.0, "units": 10.0},
        "ba.jacobians": {"calls": 10, "host_s": 0.01, "self_s": 0.01,
                         "device_ms": 50.0, "units": 10.0},
        "ba.blocks": {"calls": 10, "host_s": 0.02, "self_s": 0.02,
                      "device_ms": 150.0, "units": 10.0},
    },
    "counts": {"sift.kept": 1500, "sift.desc_rows": 6000,
               "match.cells": 4000, "match.cells_valid": 1000,
               "ba.iterations": 10, "ba.accepted": 7},
}
WANT = {"sift_pyramid_ms_per_frame.seq8": 25.0,
        "sift_desc_useful.seq8": 0.25,
        "sift_issue_ms_per_frame.stereo": 62.5,
        "match_cells_useful.exh": 0.25,
        "ba_pcg_ms_per_iter.cg": 90.0,
        "ba_linearize_ms_per_iter.cg": 20.0}


def reader(name):
    return run.load(run.BENCH / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("name", NEW)
def test_empty_recorder_reads_none(name):
    from sara_tpu_torch.utils.timing import trace
    trace.clear()
    assert reader(name)(run.Context()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_reads_none(name, monkeypatch):
    from sara_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "trace")
    assert reader(name)(run.Context()) is None


@pytest.mark.parametrize("name", NEW)
def test_value_from_a_made_up_summary(name):
    assert reader(name)(run.Context(program=SUMMARY)) == pytest.approx(
        WANT[name])


def test_each_new_metric_is_read_in_its_cell_only(bench_json):
    layer = {m["name"]: m for m in bench_json["per_layer"]}
    for name in NEW:
        m = layer[name]
        assert m["source"] == "program_counter" and len(m["workloads"]) == 1
        for cell in bench_json["workloads"]:
            names = {x["name"] for x in run.cell_metrics(bench_json, cell,
                                                         True)}
            assert (name in names) == (cell["name"] in m["workloads"])
