"""The control comes out as not correct: a run of the cell with the
reference at the configuration's lower precision in the program's place,
judged by the harness's own comparison (``run.run_cell``), is not
correct where a run of the program is.

Bundle adjustment's control (TF32 operands, rounded explicitly) runs on
the CPU. The SIFT control is TF32, which only the card has: that test is
marked ``cuda`` and skips elsewhere. Both run at sizes a test run can
hold; the readings at the cells' own sizes are in PERF.md."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.tests.conftest import _update, copy_benchmark


def _sound_and_control(root, cell, seed, seconds, device):
    """``correct`` of a run of the program and of a run with the control
    in its place, each a whole ``run.run_cell`` with its own comparison."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return [run.run_cell(bench, cell, seed, seconds, 0, device=device,
                         root=root, control=control)["correct"]
            for control in (False, True)]


def test_ba_control_fails_where_the_program_passes(tmp_path):
    # 32 cameras, 6,000 points, 33,000 observations: the smallest size at
    # which the TF32 control's gap reaches the cell's limit.
    root = copy_benchmark(tmp_path, tiny=False)
    _update(root / "benchmark" / "configs" / "ba_bal_dubrovnik356.json",
            {"cameras": 32, "points": 6000, "observations": 33000})
    assert _sound_and_control(root, "ba_bal_dubrovnik356.cg10",
                              2 ** 31 + 21, 0.2, "cpu") == [True, False]


@pytest.mark.cuda
def test_sift_control_fails_where_the_program_passes(tmp_path, card):
    root = copy_benchmark(tmp_path, tiny=False)
    _update(root / "benchmark" / "configs" / "sift_kitti.json",
            {"image_hw": [188, 620]})
    assert _sound_and_control(root, "sift_kitti.seq8", 2 ** 31 + 22, 2.0,
                              "cuda") == [True, False]
