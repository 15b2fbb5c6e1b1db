"""The twins of the frame-based tools (``scripts/torch_bench_vo_frontend.py``,
``torch_eval_real_images.py``, ``torch_eval_vo_video.py``) on the CPU,
against the JAX tools.

Each twin's ``main(argv)`` runs in this process with ``--device cpu`` at a
small size and is gated by ``chip_smoke.tool_failures``, the gates phase
"tools" applies on the card. The JAX tool runs in a subprocess (JAX on the
CPU, no x64, as a user runs it) on the same seed and size; where it reads
the reference's photographs (its data directory, missing here), the
subprocess hands it ``make_room(seed=1)``'s procedural room, the twin's own
fallback. Compared: the same accepted frames, each ATE within the gate,
map points within 5% (synthetic keypoints) or 25% (rendered pixels: RANSAC
draws from another generator).
"""

import json
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tool_twins import (  # noqa: E402
    PROCEDURAL_ROOM, last_json, run_reference, run_twin)
from chip_smoke import tool_failures  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the pipelines run batched solves; the suite
    runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)








def test_bench_vo_frontend_against_the_tool():
    """4 frames, windows of 2, batched and per frame: the same accepted
    frames as the tool, each ATE within phase "vo"'s gate (0.10)."""
    argv = ["--frames", "4", "--batch", "2"]
    out = run_twin("bench_vo_frontend", argv)
    assert set(out) == {"batched", "per-frame"}
    assert not tool_failures("bench_vo_frontend", out, argv), out
    ref = run_reference("bench_vo_frontend", argv)
    rows = re.findall(r"(batched|per-frame)\s*: (\d+)/\d+ accepted, "
                      r"\d+ ms/frame, ATE ([\d.]+)", ref)
    assert len(rows) == 2
    for mode, acc, ate in rows:
        assert out[mode]["accepted"] == int(acc)
        assert float(ate) <= 0.10


def test_eval_real_images_against_the_tool(tmp_path):
    """4 frames at 480x640 of the room: VO and global SfM on both sides,
    the same accepted frames and SfM edges, the same keys; the twin within
    ``tool_failures``' gates (VO ATE 0.10; the SfM's edges and points), and
    at these 4 views both SfM ATEs within 0.15 (at 10 views the RANSAC draw
    spreads them over 0.006-0.88 in both packages)."""
    argv = ["--frames", "4"]
    out = run_twin("eval_real_images", argv + ["--out",
                                               str(tmp_path / "t.json")])
    assert not tool_failures("eval_real_images", out, argv), out
    printed = json.loads((tmp_path / "t.json").read_text())
    assert printed == {k: out[k] for k in printed}
    ref = json.loads(run_reference(
        "eval_real_images", argv + ["--out", str(tmp_path / "j.json")],
        PROCEDURAL_ROOM))
    assert set(ref) == set(printed)
    for part in ("vo", "global_sfm"):
        assert set(ref[part]) == set(out[part])
    assert out["vo"]["accepted"] == ref["vo"]["accepted"]
    assert out["global_sfm"]["edges"] == ref["global_sfm"]["edges"]
    assert ref["vo"]["ate"] <= 0.10
    assert ref["global_sfm"]["ate"] <= 0.15 and out["global_sfm"]["ate"] <= 0.15


def test_eval_vo_video_against_the_tool(tmp_path):
    """8 frames through an mp4 (OpenCV), Brown-Conrady undistortion and the
    closer: the same streamed and accepted frames as the tool, each ATE
    before closure within 0.10."""
    pytest.importorskip("cv2")
    argv = ["--frames", "8"]
    out = run_twin("eval_vo_video",
                   argv + ["--out", str(tmp_path / "t.json"),
                           "--video", str(tmp_path / "t.mp4")])
    ref = last_json(run_reference(
        "eval_vo_video", argv + ["--out", str(tmp_path / "j.json"),
                                 "--video", str(tmp_path / "j.mp4")],
        PROCEDURAL_ROOM))
    assert set(ref) <= set(out)
    assert out["video"]["frames_streamed"] == ref["video"]["frames_streamed"]
    assert out["accepted"] == ref["accepted"]
    assert out["accepted"] >= out["video"]["frames_streamed"] - 1
    for side in (out, ref):
        assert side["ate_before_closure"] <= 0.10, (out, ref)
