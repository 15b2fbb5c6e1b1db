"""Helpers of the tests that hold the command-line tools' twins
(``scripts/torch_*.py``) against the JAX tools (``scripts/*.py``)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import load_tool  # noqa: E402

# The reference's tools read its photographs (its data directory); they
# are handed the twins' own fallback, make_room(seed=1)'s procedural room.
PROCEDURAL_ROOM = ("import eval_real_images, render3d; "
                   "eval_real_images.make_real_room = "
                   "lambda: render3d.make_room(seed=1)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module that imports this fixture (the
    pipelines run batched solves, which stop in MKL with more on this
    CPU, ROADMAP §3; the suite runs six workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def probe_function(probe: str, name: str, namespace: dict,
                   overrides: dict | None = None):
    """The function ``name`` that ``scripts/<probe>.py`` defines inside its
    ``main``, compiled on its own with its decorators, after the imports
    ``main`` makes before it; its other free names (what it reads of
    ``main``'s scope: shapes, inputs) taken from ``namespace``, and
    ``overrides`` replacing names of those imports. The probe's code as
    it stands, without running its ``main``."""
    path = ROOT / "scripts" / f"{probe}.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = []
    for node in main.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            body.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name == name:
            body.append(node)
            break
    else:
        raise KeyError(f"{probe}'s main defines no function {name}")
    scope = dict(namespace)
    exec(compile(ast.Module(body=body[:-1], type_ignores=[]), str(path),
                 "exec"), scope)
    scope.update(overrides or {})
    exec(compile(ast.Module(body=body[-1:], type_ignores=[]), str(path),
                 "exec"), scope)
    return scope[name]


def zero_masked_slots():
    """Set to zero, from now on in this process, the masked slots of the
    port's DoG detector (x, y, s) and peak finder (the angles): their
    contents are unspecified and differ between the packages' top-k tie
    orders. The fault probes' stage sums add every slot, so the tests
    compare them with the reference's slots zeroed the same way."""
    import torch

    import sara_tpu_torch.features.dog as D
    import sara_tpu_torch.features.orientation as O

    detect, peaks = D.detect_dog_octave, O.find_orientation_peaks

    def detect_dog_octave(dog, p):
        det = detect(dog, p)
        return dict(det, **{k: torch.where(det["mask"], det[k],
                                           torch.zeros_like(det[k]))
                            for k in ("x", "y", "s")})

    def find_orientation_peaks(hist, max_peaks):
        theta, ok = peaks(hist, max_peaks=max_peaks)
        return torch.where(ok, theta, torch.zeros_like(theta)), ok

    D.detect_dog_octave = detect_dog_octave
    O.find_orientation_peaks = find_orientation_peaks


def run_twin(tool: str, argv: list):
    """The twin's ``main(argv)`` on the CPU, in this process."""
    return load_tool(tool).main(argv + ["--device", "cpu"])


def _jax_command(code: str, x64: bool = False) -> tuple:
    """The command and environment that run ``code`` in a fresh
    interpreter (JAX on the CPU, without x64 as a user runs it unless
    ``x64``) with ``scripts/``, ``tests/`` and the root on its path."""
    paths = [str(ROOT / d) for d in ("scripts", "tests", "")]
    code = f"import sys; sys.path[:0] = {paths!r}\n" + code
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if x64:
        env["JAX_ENABLE_X64"] = "1"
    return [sys.executable, "-c", code], env


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


def start_reference(tool: str, argv: list, patch: str = "",
                    cpu_flag: bool = True,
                    x64: bool = False) -> subprocess.Popen:
    """``run_reference``'s subprocess (with x64 where asked), started and
    left running, so that several run at once; ``finish`` waits for
    it."""
    return start_jax(_reference_code(tool, argv, patch, cpu_flag), x64)


def start_jax(code: str, x64: bool = False) -> subprocess.Popen:
    """``code`` in a fresh interpreter (``_jax_command``), started and left
    running; ``finish`` waits for it."""
    cmd, env = _jax_command(code, x64)
    return start(cmd, env)


def start(cmd: list, env=None) -> subprocess.Popen:
    """``cmd`` from the root, its output piped, at this process's
    priority."""
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


def run_beside(proc: subprocess.Popen, fn) -> tuple:
    """(``fn()``, the standard output of ``proc``): ``fn`` runs in this
    process while the subprocess ``proc`` runs (``finish`` then waits for
    it); ``proc`` is killed if ``fn`` raises."""
    try:
        out = fn()
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return out, finish(proc)


def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])
