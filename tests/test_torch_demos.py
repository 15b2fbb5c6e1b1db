"""The demo twins ``examples/torch_*.py`` on the CPU.

Each twin's ``main(argv)`` runs in this process with ``--cpu`` at a small
size (the synthetic pair at 240 px wide, 6 VO frames, 4 SfM views) and is
gated on its result against the synthetic truth by
``chip_smoke.demo_failures``, the gates phase "demos" applies on the card:
the 16-px shift and the inlier share (two-view), the homography's corners
within 2% of the width, the rotation within 2 degrees (five-point), the BA's
RMS falling below 0.5 px, every VO frame accepted with ATE <= 0.05, and
views - 1 SfM edges with the float64 solution of the SfM's own BA problem
within ATE 0.05. At these 4 views the float32 SfM's ATE is also held to
0.1 here; at the card's 8 views its float32 BA stalls where summation
order says, in both packages (ROADMAP §3, F6), so the card logs it.

The two JAX demos that run here without photographs,
``visual_odometry_demo.py --synthetic`` and ``global_sfm_demo.py``, with the
same arguments, print what their recordings hold (``tool_twins.Reference``)
where a recording's fingerprint matches the tree; else they run live in a
subprocess (JAX on the CPU, no x64, as a user runs them). The twin's
printed numbers are held to theirs: VO, the same
accepted frames, point counts within 5%, ATE within 0.005 of the
reference's; SfM, each view's keypoint count within 3%, the same number of
verified pairs, points within 25% (RANSAC draws from another generator)
and ATE within 0.02 of the reference's.
"""

import contextlib
import io
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from chip_smoke import DEMOS, demo_failures, load_demo  # noqa: E402
from tool_twins import OUT, script_reference  # noqa: E402

WIDTH = 240
SFM_VIEWS = 4
VO_FRAMES = 6
# Time limits (s) of the JAX demos where they run live: about three times
# each one's wall time in the loaded suite, at least 120 s.
VISUAL_ODOMETRY_SECONDS = 150
GLOBAL_SFM_SECONDS = 540


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the global SfM twin runs batched solves; the
    suite runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def argv_of(name, out_dir):
    argv = list(DEMOS[name][1])
    if name == "visual_odometry":
        argv += ["--max-frames", str(VO_FRAMES)]
    elif name == "global_sfm":
        argv += ["--views", str(SFM_VIEWS)]
    else:
        argv += ["--width", str(WIDTH)]
    if name != "essential_5_point":
        argv += ["--out", str(out_dir)]
    return argv


def run_twin(name, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = load_demo(name).main(argv + ["--cpu"])
    return out, printed.getvalue()


# The JAX demos the twins' printed numbers are held to.
JAX_DEMOS = {name: script_reference(
    f"demos.{name}", f"examples/{name}_demo.py",
    argv_of(name, OUT) + ["--cpu"], seconds, varies=varies)
    for name, seconds, varies in (
        ("visual_odometry", VISUAL_ODOMETRY_SECONDS, ()),
        ("global_sfm", GLOBAL_SFM_SECONDS,
         (r"\([\d.]+s( incl\. compile)?\)",)))}


def run_reference(name, out):
    """The JAX demo's standard output (``JAX_DEMOS``)."""
    return JAX_DEMOS[name].start(out).output().text


def numbers(pattern, text):
    return [tuple(float(g) if "." in g else int(g) for g in m)
            if isinstance(m, tuple) else (float(m) if "." in m else int(m))
            for m in re.findall(pattern, text)]


@pytest.mark.parametrize("name", list(DEMOS))
def test_demo_twin_needs_a_card_or_cpu(name, tmp_path):
    """Without ``--cpu`` a twin runs on the card, and raises without one
    before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (phase demos runs the twins "
                    "on it)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_demo(name).main(argv_of(name, tmp_path))


@pytest.mark.parametrize("name", list(DEMOS))
def test_demo_twin(name, tmp_path):
    out, printed = run_twin(name, argv_of(name, tmp_path / "twin"))
    assert not demo_failures(name, out, WIDTH, SFM_VIEWS), printed
    if name == "visual_odometry":
        ref = run_reference(name, tmp_path / "jax")
        pat = r"frame (\d+): (pose added|rejected); (\d+) points"
        got, want = (re.findall(pat, text) for text in (printed, ref))
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            assert abs(int(g[2]) - int(w[2])) <= 0.05 * int(w[2])
        (ate_t,), (ate_j,) = (numbers(r"ATE-RMSE vs ground truth: ([\d.]+)",
                                      text) for text in (printed, ref))
        assert abs(ate_t - ate_j) <= 0.005
    elif name == "global_sfm":
        assert out["ate"] <= 0.1, printed
        ref = run_reference(name, tmp_path / "jax")
        kp_t, kp_j = (numbers(r"(\d+)", re.search(r"\[([\d, ]+)\]",
                                                  text).group(1))
                      for text in (printed, ref))
        assert len(kp_t) == len(kp_j) == SFM_VIEWS
        assert all(abs(a - b) <= 0.03 * b for a, b in zip(kp_t, kp_j))
        pat = r"global SfM: (\d+) verified pairs, (\d+) points"
        ((e_t, p_t),), ((e_j, p_j),) = (numbers(pat, text)
                                        for text in (printed, ref))
        assert e_t == e_j == out["edges"]
        assert abs(p_t - p_j) <= 0.25 * p_j
        (ate_t,), (ate_j,) = (numbers(r"ATE vs ground truth: ([\d.]+)", text)
                              for text in (printed, ref))
        assert abs(ate_t - ate_j) <= 0.02
