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


def _jax_command(code: str) -> tuple:
    """The command and environment that run ``code`` in a fresh
    interpreter (JAX on the CPU, no x64, as a user runs it) with
    ``scripts/``, ``tests/`` and the root on its path."""
    paths = [str(ROOT / d) for d in ("scripts", "tests", "")]
    code = f"import sys; sys.path[:0] = {paths!r}\n" + code
    return ([sys.executable, "-c", code],
            dict(os.environ, JAX_PLATFORMS="cpu"))


def run_jax(code: str) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter (``_jax_command``); fails unless it
    exits with 0."""
    cmd, env = _jax_command(code)
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def _reference_code(tool: str, argv: list, patch: str,
                    cpu_flag: bool) -> str:
    argv = argv + (["--cpu"] if cpu_flag else [])
    return "\n".join([patch, f"import {tool}",
                      f"sys.argv = [{tool!r}] + {argv!r}", f"{tool}.main()"])


def run_reference(tool: str, argv: list, patch: str = "",
                  cpu_flag: bool = True, stream: str = "stdout") -> str:
    """The JAX tool ``scripts/<tool>.py`` with ``argv`` (and ``--cpu``) in
    a subprocess (``run_jax``), after ``patch``; its standard output, or
    its standard error with ``stream="stderr"`` (a tool that logs
    there)."""
    return getattr(run_jax(_reference_code(tool, argv, patch, cpu_flag)),
                   stream)


def start_reference(tool: str, argv: list,
                    patch: str = "") -> subprocess.Popen:
    """``run_reference``'s subprocess, started and left running, so that
    several run at once; ``finish`` waits for it."""
    cmd, env = _jax_command(_reference_code(tool, argv, patch, True))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float = 900) -> str:
    """The standard output of a ``start_reference`` subprocess, which must
    exit with 0 within ``timeout`` seconds (it is killed otherwise)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out + err
    return out


def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])
