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


def run_jax(code: str) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter (JAX on the CPU, no x64, as a user
    runs it) with ``scripts/``, ``tests/`` and the root on its path; fails
    unless it exits with 0."""
    paths = [str(ROOT / d) for d in ("scripts", "tests", "")]
    code = f"import sys; sys.path[:0] = {paths!r}\n" + code
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def run_reference(tool: str, argv: list, patch: str = "",
                  cpu_flag: bool = True, stream: str = "stdout") -> str:
    """The JAX tool ``scripts/<tool>.py`` with ``argv`` (and ``--cpu``) in
    a subprocess (``run_jax``), after ``patch``; its standard output, or
    its standard error with ``stream="stderr"`` (a tool that logs
    there)."""
    argv = argv + (["--cpu"] if cpu_flag else [])
    code = "\n".join([patch, f"import {tool}",
                      f"sys.argv = [{tool!r}] + {argv!r}", f"{tool}.main()"])
    return getattr(run_jax(code), stream)


def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])
