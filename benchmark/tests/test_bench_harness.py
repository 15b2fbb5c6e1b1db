"""The harness is driven by data: a new configuration, traffic mix and
metric are new files and new entries, found by name, with no existing file
edited; and a run without a card fails rather than falling back."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import pytest

from benchmark import run


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_files_and_entries(tiny_root):
    before = _digests(tiny_root / "benchmark")
    b = tiny_root / "benchmark"
    cfg = json.loads((b / "configs" / "sift_kitti.json").read_text())
    cfg["image_hw"] = [48, 128]
    (b / "configs" / "sift_small.json").write_text(json.dumps(cfg))
    (b / "traffic" / "pairs4.json").write_text(json.dumps({
        "frames": 4, "unit_frames": 2, "batch": 2, "pairs": "previous",
        "pair_chunk": 0, "in_flight": 1, "check_span": 1, "check_units": 1,
        "check_frames": 0, "trace_units": 1, "sync_units": 1}))
    (b / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(ctx.stats['frames'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sift_small", "source": "a test",
                             "file": "benchmark/configs/sift_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sift_small.pairs4",
                               "config": "sift_small", "traffic": "pairs4",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("sift_small.pairs4")
    bench["per_layer"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "frames_per_s",
                               "workloads": ["sift_small.pairs4"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace, want in ((0, {"frames_per_s", "setup_s"}),
                        (1, {"frames_done"})):
        out = run.run_cell(bench, "sift_small.pairs4", 2 ** 33 + trace, 0.5,
                           trace, device="cpu", root=tiny_root)
        assert set(out["metrics"]) == want
        assert out["correct"] and out["seen"]["frames_checked"] > 0
        assert list(out)[-1] == "checks"
    after = _digests(tiny_root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_metrics_of_each_cell(bench_json):
    """Every cell reports setup_s, one other end-to-end metric and at
    least one per-layer metric; every metric has a reader."""
    for cell in bench_json["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(bench_json, cell, False)}
        layer = run.cell_metrics(bench_json, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if m["name"] != "setup_s":
            assert (run.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_without_a_card_the_run_fails(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sift_kitti.seq8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny_root, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout
