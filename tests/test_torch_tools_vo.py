"""The twin of the VO evaluation tool (``scripts/torch_eval_vo.py``) on the
CPU, against the JAX tool; and every twin's refusal to run without a card
unless asked for the CPU.

Each twin's ``main(argv)`` runs in this process with ``--device cpu`` at a
small size and is gated by ``chip_smoke.tool_failures``, the gates phase
"tools" applies on the card. The JAX tool's output on the same seed and
size is its recording (``tool_twins.Reference``) where the recording's
fingerprint matches the tree; else the tool runs live in a subprocess (JAX
on the CPU, no x64, as a user runs it), started before the twin and
running beside it (``tool_twins.run_beside``). Where it reads the
reference's photographs (its data directory, missing here), the program
hands it ``make_room(seed=1)``'s procedural room, the twin's own fallback.
Compared: the same accepted frames, each ATE within the gate,
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
    OUT, PROCEDURAL_ROOM, json_fields, last_json, run_beside, run_twin,
    tool_reference)
from chip_smoke import load_tool, tool_failures  # noqa: E402

# Time limits (s) of the JAX tool where it runs live: about three times
# each run's wall time in the loaded suite, at least 120 s.
EVAL_VO_KEYPOINTS_SECONDS = 180
EVAL_VO_ROOM_SECONDS = 1000

KEYPOINTS_ARGV = ["--frames", "12"]
EVAL_VO_KEYPOINTS = tool_reference(
    "tools_vo.eval_vo_keypoints", "eval_vo", KEYPOINTS_ARGV,
    EVAL_VO_KEYPOINTS_SECONDS, varies=(r"throughput: .*",))
ROOM_ARGV = ["--room", "--loop", "--frames", "40", "--height", "180",
             "--width", "240"]
EVAL_VO_ROOM = tool_reference(
    "tools_vo.eval_vo_room", "eval_vo",
    ROOM_ARGV + ["--out", f"{OUT}/j.json"], EVAL_VO_ROOM_SECONDS,
    patch=PROCEDURAL_ROOM, varies=(json_fields(
        "fps", "ms_per_frame", "steady_ms_per_frame", "steady_fps"),))



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the pipelines run batched solves; the suite
    runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)








TWINS = ["eval_vo", "bench_vo_frontend", "bench_ba", "bench_sfm_scale",
         "bench_city_scale", "bench_config5_real", "eval_real_images",
         "mc_fivepoint", "eval_vo_video"]


@pytest.mark.parametrize("tool", TWINS)
def test_tool_twin_needs_a_card_or_cpu(tool):
    """Without ``--device`` a twin runs on the card, and raises without one
    before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (phase tools runs the twins "
                    "on it)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_tool(tool).main([])


def test_eval_vo_keypoints_against_the_tool():
    """12 synthetic keypoint frames: every frame accepted on both sides,
    ATE within eval_vo's gate (0.05), map points within 5%."""
    argv = KEYPOINTS_ARGV
    out, ref = run_beside(EVAL_VO_KEYPOINTS.start(),
                          lambda: run_twin("eval_vo", argv))
    ref = ref.text
    assert not tool_failures("eval_vo", out, argv)
    (acc, n), = re.findall(r"frames accepted: (\d+)/(\d+)", ref)
    (ate,), (pts,) = (re.findall(p, ref) for p in (
        r"ATE-RMSE before loop closure: ([\d.]+)", r"map points: (\d+)"))
    assert out["accepted"] == int(acc) == 12
    assert float(ate) <= 0.05 and out["ate_before"] <= 0.05
    assert abs(out["map_points"] - int(pts)) <= 0.05 * int(pts)


def test_eval_vo_room_against_the_tool(tmp_path):
    """The room loop at 180x240 over 40 frames with closure (smaller loops
    lose track in both packages: at 96x128 over 16 frames the pipeline
    accepts frame 0 only): the same accepted frames and the same keys;
    the reference's ATE before closure within phase "vo"'s gate (0.10),
    the twin's within ``tool_failures``' gates. Closure on this coarse loop
    raises the ATE in both packages (ROADMAP F3; the reference 0.0849 ->
    0.2847 on the CPU), so the twin's ATE after closure is held to 1.25
    times the reference's own plus 0.02."""
    argv = ROOM_ARGV
    out, ref = run_beside(EVAL_VO_ROOM.start(tmp_path), lambda: run_twin(
        "eval_vo", argv + ["--out", str(tmp_path / "t.json")]))
    assert not tool_failures("eval_vo_room", out, argv), out
    assert json.loads((tmp_path / "t.json").read_text())[-1] == out
    ref = last_json(ref.text)
    assert out["accepted"] == ref["accepted"]
    assert set(ref) <= set(out)
    assert ref["ate_before_closure"] <= 0.10, ref
    assert ref["loop_closed"]
    assert out["ate_after_closure"] <= 1.25 * ref["ate_after_closure"] \
        + 0.02, (out, ref)
    assert abs(out["map_points"] - ref["map_points"]) <= \
        0.25 * ref["map_points"]


def test_eval_vo_pipelined_room():
    """``--pipelined``: the same room loop through ``process_frames`` with
    the closer on the ``on_accept`` hook, held by ``tool_failures``' gates
    (the reference's tool ends at ATE 0.0833 -> 0.2666 here, the twin at
    0.1255 -> 0.2199 with one torch thread and 0.0800 -> 0.2612 with two:
    the float32 VO's spread, ROADMAP F6)."""
    argv = ["--room", "--loop", "--pipelined", "--frames", "40",
            "--height", "180", "--width", "240", "--out", ""]
    out = run_twin("eval_vo", argv)
    assert out["pipelined"]
    assert not tool_failures("eval_vo_room", out, argv), out
