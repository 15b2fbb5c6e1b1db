"""Helpers of the tests that hold the command-line tools' twins
(``scripts/torch_*.py``) against the JAX tools (``scripts/*.py``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import load_tool  # noqa: E402

# The reference's tools read its photographs (its data directory); they
# are handed the twins' own fallback, make_room(seed=1)'s procedural room.
PROCEDURAL_ROOM = ("import eval_real_images, render3d; "
                   "eval_real_images.make_real_room = "
                   "lambda: render3d.make_room(seed=1)")


def run_twin(tool: str, argv: list):
    """The twin's ``main(argv)`` on the CPU, in this process."""
    return load_tool(tool).main(argv + ["--device", "cpu"])


def run_reference(tool: str, argv: list, patch: str = "",
                  cpu_flag: bool = True) -> str:
    """The JAX tool ``scripts/<tool>.py`` with ``argv`` (and ``--cpu``) in
    a subprocess (JAX on the CPU, no x64, as a user runs it), after
    ``patch``; its standard output."""
    paths = [str(ROOT / d) for d in ("scripts", "tests", "")]
    argv = argv + (["--cpu"] if cpu_flag else [])
    code = "\n".join([f"import sys; sys.path[:0] = {paths!r}", patch,
                      f"import {tool}", f"sys.argv = [{tool!r}] + {argv!r}",
                      f"{tool}.main()"])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])
