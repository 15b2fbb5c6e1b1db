"""The twin of ``scripts/eval_detection_quality.py``,
``scripts/torch_eval_detection_quality.py``, against the JAX tool.

A seeded procedural 480x640 PNG (one smooth-noise texture of
``tests/render3d.py::make_room(seed=1, tex_size=640)``, its first 480
rows) goes through the JAX tool in a subprocess (JAX on the CPU without
x64; the tool pins the CPU itself and logs to stderr only; its recording,
``tool_twins.Reference``, where the recording's fingerprint matches the
tree) and through the twin's ``main`` with ``--device cpu`` in this
process, both at ``--first-octave 0``: at -1 the JAX tool takes ~45 s on
such a texture and fills ``total_capacity``.

Both sides warp with the same ``cv2`` and run the same OpenCV SIFT, so
their OpenCV lines are equal. The port's SIFT differs from the reference's
by its descriptor sampler (bilinear kernel sampler against nearest
gathers) and the ulps of its pyramid. On three such textures (seeds 1-3,
an 8-core Intel Xeon) the twin's keypoint counts came within 3 of the
tool's (0.1%), its repeatability within 0.001 and its matches and correct
matches within 4 (0.2%). The bounds below, about ten times that spread
(counts within 1%, repeatability within 0.01, matches and correct matches
within 2%), leave room for other CPUs. The helpers are held equal to the
tool's on seeded inputs.
"""

import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tool_twins import OUT, ROOT, last_json, tool_reference  # noqa: E402
from chip_smoke import (detection_quality, load_tool,  # noqa: E402
                        tool_failures)

# Time limit (s) of the JAX tool where it runs live: about three times its
# wall time in the loaded suite, at least 120 s.
TOOL_SECONDS = 160

ARGV = ["--first-octave", "0"]
# The seeded texture, written as a PNG to ``path`` by the port's writer,
# for the tool's program and the twin alike.
WRITE_TEXTURE = """
import numpy as np
from render3d import make_room
from sara_tpu_torch.io.image import imwrite
tex = make_room(seed=1, tex_size=640)[0].tex[:480]
imwrite({path!r}, (np.clip(tex, 0, 1) * 255).round().astype(np.uint8))
"""
TOOL = tool_reference(
    "tools_quality.eval_detection_quality", "eval_detection_quality",
    ARGV + ["--image", f"{OUT}/texture.png"], TOOL_SECONDS,
    patch=WRITE_TEXTURE.format(path=f"{OUT}/texture.png"), cpu_flag=False,
    stream="stderr", varies=(r"t=\d+\.\d\ds",))
# The tool's three stderr lines, word for word (the seconds aside).
DETECTOR_LINE = re.compile(
    r"(opencv|ours\(fo=-?\d+\)): kp (\d+)/(\d+) t=\d+\.\d\ds repeatability "
    r"(\d\.\d{3}) \((\d+) projected\) matches (\d+) correct (\d+)")
RATIO_LINE = re.compile(r"kp ratio (\d+\.\d\d)  correct-match ratio "
                        r"(\d+\.\d\d)")
KP_REL, REP_ABS, MATCH_REL = 0.01, 0.01, 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool():
    """The JAX tool's module (it imports JAX only inside ``run_ours`` and
    ``main``)."""
    path = ROOT / "scripts" / "eval_detection_quality.py"
    spec = importlib.util.spec_from_file_location("eval_detection_quality",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse(stderr: str) -> dict:
    """The tool's three lines of ``stderr``, parsed; fails unless each
    has the tool's format."""
    lines = [ln for ln in stderr.splitlines()
             if DETECTOR_LINE.fullmatch(ln) or RATIO_LINE.fullmatch(ln)]
    assert len(lines) == 3, stderr
    out = {}
    for ln in lines[:2]:
        g = DETECTOR_LINE.fullmatch(ln).groups()
        out["opencv" if g[0] == "opencv" else "ours"] = dict(
            head=g[0], kp=[int(g[1]), int(g[2])], repeatability=float(g[3]),
            projected=int(g[4]), matches=int(g[5]), correct=int(g[6]))
    assert [ln.split(":")[0] for ln in lines[:2]] == ["opencv", "ours(fo=0)"]
    out["ratios"] = [float(x) for x in RATIO_LINE.fullmatch(lines[2]).groups()]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The PNG through the JAX tool and the twin: (tool's parsed lines,
    twin's parsed lines, twin's result, twin's stdout, --out path)."""
    tmp = tmp_path_factory.mktemp("quality")
    png = str(tmp / "texture.png")
    exec(WRITE_TEXTURE.format(path=png), {})
    argv = ARGV + ["--image", png]
    ref = _parse(TOOL.start(tmp_path_factory.mktemp("tool")).output().text)
    out = str(tmp / "twin.json")
    err, std = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(std):
        res = load_tool("eval_detection_quality").main(
            argv + ["--device", "cpu", "--out", out])
    return ref, _parse(err.getvalue()), res, std.getvalue(), out


def test_logs_the_tools_lines(runs):
    """The twin's stderr holds the tool's three lines in the tool's format
    (``_parse`` fails otherwise), and they state its result."""
    _, twin, res, _, _ = runs
    for side in ("opencv", "ours"):
        r = res[side]
        assert twin[side]["kp"] == r["kp"]
        assert twin[side]["repeatability"] == round(r["repeatability"], 3)
        assert [twin[side][k] for k in ("projected", "matches", "correct")] \
            == [r[k] for k in ("projected", "matches", "correct")]
    assert twin["ratios"] == [round(res["kp_ratio"], 2),
                              round(res["correct_match_ratio"], 2)]


def test_json_line_and_out_file(runs):
    """The last stdout line is the result as JSON, and so is ``--out``."""
    _, _, res, stdout, out = runs
    want = json.loads(json.dumps(res))
    assert last_json(stdout) == want
    assert json.loads(Path(out).read_text()) == want
    assert res["size"] == [480, 640] and res["device"] == "cpu"


def test_opencv_lines_equal(runs):
    """The same cv2 warp and SIFT on both sides: the same numbers."""
    ref, twin, _, _, _ = runs
    assert twin["opencv"] == ref["opencv"]


def test_ours_within_bounds(runs):
    """The port's SIFT + matcher against the reference's on the same
    pair, at the bounds of the module docstring."""
    ref, twin, _, _, _ = runs
    r, t = ref["ours"], twin["ours"]
    assert t["head"] == r["head"] == "ours(fo=0)"
    for a, b in zip(t["kp"], r["kp"]):
        assert abs(a - b) <= KP_REL * b, (t["kp"], r["kp"])
    assert abs(t["repeatability"] - r["repeatability"]) <= REP_ABS
    for k in ("matches", "correct"):
        assert abs(t[k] - r[k]) <= MATCH_REL * r[k], (k, t[k], r[k])
    assert t["correct"] >= 0.95 * t["matches"] > 1000


def _seeded_points(seed, n=300, h=480, w=640):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(-20, w + 20, n), rs.uniform(-20, h + 20, n)],
                    axis=1)


@pytest.mark.parametrize("name", ["make_warp", "project", "interior_mask",
                                  "repeatability", "match_quality"])
def test_helpers_equal_tool(name):
    """Each numpy helper of the twin returns the tool's values on seeded
    inputs (and on an empty set where the tool has a branch for it)."""
    tool, twin = _tool(), load_tool("eval_detection_quality")
    h, w = 480, 640
    H = tool.make_warp(h, w)
    xy_a, xy_b = _seeded_points(0), _seeded_points(1)
    xy_b[:150] = tool.project(H, xy_a[:150]) + np.random.RandomState(
        2).normal(scale=1.5, size=(150, 2))
    pairs = np.stack([np.arange(300), np.random.RandomState(3).permutation(
        300)], axis=1)
    pairs[:100, 1] = np.arange(100)
    cases = {
        "make_warp": [(h, w), (240, 320, 30.0, 1.2, -5.0, 7.5)],
        "project": [(H, xy_a), (np.eye(3), xy_b)],
        "interior_mask": [(xy_a, h, w), (xy_b, h, w, 30)],
        "repeatability": [(xy_a, xy_b, H, h, w), (xy_a, xy_b, H, h, w, 0.5),
                          (xy_a, xy_b[:0], H, h, w)],
        "match_quality": [(xy_a, xy_b, pairs, H), (xy_a, xy_b, pairs, H, 1.0),
                          (xy_a, xy_b, pairs[:0], H)],
    }[name]
    for args in cases:
        got, want = getattr(twin, name)(*args), getattr(tool, name)(*args)
        if isinstance(want, tuple):
            assert got == want, (args, got, want)
        else:
            np.testing.assert_array_equal(got, want)


def test_needs_cv2_and_an_image(tmp_path, monkeypatch):
    """As the tool: a missing ``--image`` raises, and the warp needs cv2
    (without it ``main`` raises); ``--device cuda`` raises without a
    card."""
    from sara_tpu_torch.io.image import imwrite

    twin = load_tool("eval_detection_quality")
    png = str(tmp_path / "flat.png")
    imwrite(png, np.full((48, 64), 128, np.uint8))
    with pytest.raises(FileNotFoundError):
        twin.main(["--image", str(tmp_path / "missing.png"), "--device",
                   "cpu", "--out", ""])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twin.main(["--image", png, "--out", ""])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        twin.main(["--image", png, "--device", "cpu", "--out", ""])


def test_card_run_on_cpu():
    """Phase "tools"'s run of the twin (``chip_smoke.detection_quality``:
    ``run_ours`` at the tool's defaults on a texture and its warp by
    ``warp_homography``, no OpenCV) on the CPU at 240x320, held to the
    phase's gates (>= 95% of matches correct, the repeatability floor)."""
    out = detection_quality("cpu", hw=(240, 320))
    assert not tool_failures("eval_detection_quality", out, []), out
    assert min(out["kp"]) > 1000 and out["opencv"].startswith("skipped")
