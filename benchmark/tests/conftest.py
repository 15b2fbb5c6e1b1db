"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): the checkout's root on ``sys.path``, a copy of the
benchmark shrunk to sizes the CPU runs in seconds, and the card fixture
that skips a test marked ``cuda`` where there is no card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {
    "sift_kitti": {"image_hw": [64, 160]},
    "ba_bal_dubrovnik356": {"cameras": 12, "points": 1500,
                            "observations": 8000},
}
TINY_TRAFFIC = {
    "seq8": {"frames": 8, "unit_frames": 2, "batch": 2, "check_span": 1,
             "check_units": 1},
    "stereo_live": {"frames": 4, "check_span": 1, "check_units": 1},
    "exhaustive50": {"frames": 8, "unit_frames": 4, "batch": 2,
                     "pair_chunk": 4, "check_span": 1, "check_units": 1,
                     "check_frames": 3},
}


def _update(path: Path, changes: dict):
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def copy_benchmark(dst: Path, tiny: bool = True) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dst``,
    shrunk to CPU sizes where ``tiny``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    if tiny:
        for name, ch in TINY_CONFIG.items():
            _update(dst / "benchmark" / "configs" / f"{name}.json", ch)
        for name, ch in TINY_TRAFFIC.items():
            _update(dst / "benchmark" / "traffic" / f"{name}.json", ch)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture
def bench_json():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
