"""Helpers of the tests that hold the command-line tools' twins
(``scripts/torch_*.py``) against the JAX tools (``scripts/*.py``).

A JAX reference program the tests compare with is declared once, as a
``Reference``, and read through ``Reference.start``. It runs at fixed
seeds, sizes and argv, and its output is kept under
``tests/data/reference_runs/``, keyed by what produces it: the program's
argv and environment, the versions of the packages it imports and the
source of every repository file it loads. Where that fingerprint matches
the tree as it stands, the test reads the recording; where it does not,
the program runs live, as a user runs it. ``tests/test_reference_runs.py``
fails on a stale recording; ``python tests/record_reference_runs.py
[key ...]`` records anew.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import platform
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The reference's tools read its photographs (its data directory); they
# are handed the twins' own fallback, make_room(seed=1)'s procedural room.
PROCEDURAL_ROOM = ("import eval_real_images, render3d; "
                   "eval_real_images.make_real_room = "
                   "lambda: render3d.make_room(seed=1)")
RECORDINGS = ROOT / "tests" / "data" / "reference_runs"
# Where a reference's argv names its output directory, and the root; both
# stand as these marks in a program's fingerprint and recorded output.
OUT = "@OUT@"
ROOT_MARK = "@ROOT@"
# The environment variables of a run that its fingerprint holds.
FINGERPRINT_ENV = ("JAX_", "XLA_")
RECORD_COMMAND = "python tests/record_reference_runs.py"


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
    from chip_smoke import load_tool

    return load_tool(tool).main(argv + ["--device", "cpu"])


def marked(text: str, out=None) -> str:
    """``text`` with the root (and ``out``) as their marks."""
    if out is not None:
        text = text.replace(str(out), OUT)
    return text.replace(str(ROOT), ROOT_MARK)


def _unmarked(text: str, out) -> str:
    return text.replace(ROOT_MARK, str(ROOT)).replace(OUT, str(out))


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@functools.lru_cache(maxsize=None)
def file_sha(rel: str):
    """The sha256 of the repository file ``rel``, None if it is gone."""
    path = ROOT / rel
    return _sha(path.read_bytes()) if path.is_file() else None


def _reference_data():
    """The listing of the reference's data directory (its photographs,
    which some programs read where they exist), None without one."""
    from sara_tpu_torch.io.datasets import REFERENCE_DATA

    return (sorted(os.listdir(REFERENCE_DATA))
            if os.path.isdir(REFERENCE_DATA) else None)


@functools.lru_cache(maxsize=None)
def _version(dist: str):
    """The installed version of the distribution ``dist``, None without
    one."""
    import importlib.metadata as md

    try:
        return md.version(dist)
    except md.PackageNotFoundError:
        return None


def versions(dists) -> dict:
    """The installed version of each distribution of ``dists``."""
    return {d: _version(d) for d in dists}


def fingerprint(program: dict, sources: dict, dists: dict) -> str:
    """The sha256 of what makes a reference's output: its ``program``
    (``Reference.program``), the sha256 of each repository file it loads
    (``sources``), the versions of the distributions it imports
    (``dists``), Python's version and the reference's data directory."""
    return _sha(json.dumps(dict(program=program, sources=sources,
                                versions=dists, data=_reference_data(),
                                python=platform.python_version()),
                           sort_keys=True).encode())


@dataclasses.dataclass(frozen=True)
class Output:
    """What a reference printed on the stream its tests read, and the
    files it wrote (name: path). In a recorded text file the root and the
    run's output directory stand as their marks."""
    text: str
    files: dict


@dataclasses.dataclass(frozen=True)
class Reference:
    """A JAX program that twin tests compare with: the interpreter's argv
    (``OUT`` naming the run's output directory, ``ROOT_MARK`` the root),
    the environment it sets over this process's, the files it writes
    into ``OUT``, the stream the tests read, its time limit in seconds,
    and the patterns of its output that vary from run to run (no test
    reads them; the replay check leaves them out)."""
    key: str
    argv: tuple
    env: tuple
    timeout: float
    files: tuple = ()
    stream: str = "stdout"
    varies: tuple = ()

    def command(self, out) -> tuple:
        """The command and environment of a live run writing into
        ``out``."""
        env = dict(os.environ, **dict(self.env))
        return ([sys.executable] + [_unmarked(a, out) for a in self.argv],
                env)

    def program(self) -> dict:
        """The argv and environment that the fingerprint holds;
        ``XLA_FLAGS`` with each flag once (the suite's conftest appends its
        flag again in each xdist worker)."""
        _, env = self.command(OUT)
        env = {k: v for k, v in sorted(env.items())
               if k.startswith(FINGERPRINT_ENV)}
        if "XLA_FLAGS" in env:
            flags = env["XLA_FLAGS"].split()[::-1]
            env["XLA_FLAGS"] = " ".join(list(dict.fromkeys(flags))[::-1])
        return dict(argv=list(self.argv), env=env)

    @property
    def meta_path(self) -> Path:
        return RECORDINGS / f"{self.key}.json"

    def stale(self):
        """None where the recording matches the tree as it stands, else
        why it does not."""
        try:
            meta = json.loads(self.meta_path.read_text())
        except FileNotFoundError:
            return "no recording"
        if meta["program"] != self.program():
            return "the program or its environment changed"
        if (meta["files"], meta["stream"]) != (list(self.files),
                                               self.stream):
            return "the files or the stream its tests read changed"
        sources = {rel: file_sha(rel) for rel in meta["sources"]}
        changed = sorted(r for r, s in sources.items()
                         if s != meta["sources"][r])
        if changed:
            return "changed: " + ", ".join(changed)
        if list(package_sources()) != sorted(
                r for r in meta["sources"] if r.startswith("sara_tpu/")):
            return "the files of sara_tpu/ changed"
        dists = versions(meta["versions"])
        if dists != meta["versions"]:
            return f"versions changed: {dists}"
        if fingerprint(self.program(), sources, dists) != \
                meta["fingerprint"]:
            return ("the fingerprint differs (Python's version or the "
                    "reference's data directory)")
        return None

    def recording(self) -> Output:
        """The recorded output (its files read from the recording)."""
        files = RECORDINGS / self.key
        text = (RECORDINGS / f"{self.key}.{self.stream}").read_text()
        return Output(_unmarked(text, files),
                      {f: files / f for f in self.files})

    def start(self, out: Path | None = None) -> "Run":
        """The recording where its fingerprint matches the tree as it
        stands (``stale``), else the program started live in a subprocess
        writing into ``out`` (a directory), left running so that the
        caller works beside it."""
        if self.stale() is None:
            return Run(self, None, self.recording())
        return self.start_live(out)

    def start_live(self, out: Path | None = None) -> "Run":
        """The program started live in a subprocess writing into ``out``,
        whatever its recording."""
        cmd, env = self.command(out)
        return Run(self, start(cmd, env), None, out)


@functools.lru_cache(maxsize=None)
def package_sources() -> tuple:
    """The reference package's files, every one of which a fingerprint
    holds."""
    return tuple(sorted(str(p.relative_to(ROOT))
                        for p in (ROOT / "sara_tpu").rglob("*.py")))


class Run:
    """A started reference: its recording, or its live subprocess."""

    def __init__(self, ref: Reference, proc, output: Output | None,
                 out: Path | None = None):
        self.ref, self.proc, self._output, self.out = ref, proc, output, out

    def output(self) -> Output:
        """The output, waiting up to the reference's time limit for a
        live run, which must exit with 0 (it is killed otherwise)."""
        if self._output is None:
            text = finish(self.proc, self.ref.timeout, self.ref.stream)
            self._output = Output(text, {f: self.out / f
                                         for f in self.ref.files})
        return self._output

    def kill(self):
        """End a live run that is still going."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def jax_reference(key: str, code: str, timeout: float, x64: bool = False,
                  **kw) -> Reference:
    """``code`` in a fresh interpreter, JAX on the CPU, without x64 as a
    user runs it unless ``x64``, with ``scripts/``, ``tests/`` and the root
    on its path."""
    paths = [f"{ROOT_MARK}/{d}".rstrip("/") for d in ("scripts", "tests",
                                                      "")]
    code = f"import sys; sys.path[:0] = {paths!r}\n" + code
    env = [("JAX_PLATFORMS", "cpu")] + ([("JAX_ENABLE_X64", "1")]
                                        if x64 else [])
    return Reference(key, ("-c", code), tuple(env), timeout, **kw)


def tool_reference(key: str, tool: str, argv: list, timeout: float,
                   patch: str = "", cpu_flag: bool = True,
                   **kw) -> Reference:
    """The JAX tool ``scripts/<tool>.py`` with ``argv`` (and ``--cpu``),
    after ``patch``, through ``jax_reference``."""
    argv = argv + (["--cpu"] if cpu_flag else [])
    code = "\n".join([patch, f"import {tool}",
                      f"sys.argv = [{tool!r}] + {argv!r}", f"{tool}.main()"])
    return jax_reference(key, code, timeout, **kw)


def script_reference(key: str, script: str, argv: list, timeout: float,
                     **kw) -> Reference:
    """The script ``script`` (relative to the root) with ``argv``, JAX on
    the CPU."""
    return Reference(key, (f"{ROOT_MARK}/{script}", *argv),
                     (("JAX_PLATFORMS", "cpu"),), timeout, **kw)


def held(value) -> list:
    """The references ``value`` is, or holds as a dict's values or a list's
    or tuple's items."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, Reference)]
    return [value] if isinstance(value, Reference) else []


def declared() -> dict:
    """Every reference that a test module binds to a module-level name
    (each module of ``tests/`` that calls a ``*_reference`` maker is
    imported), by key: (reference, its module)."""
    out = {}
    for path in sorted((ROOT / "tests").glob("test_*.py")):
        if "_reference(" not in path.read_text():
            continue
        mod = __import__(path.stem)
        for value in list(vars(mod).values()):
            for ref in held(value):
                if out.setdefault(ref.key, (ref, mod))[0] != ref:
                    raise ValueError(f"two references named {ref.key}")
    return out


def start(cmd: list, env=None) -> subprocess.Popen:
    """``cmd`` from the root, its output piped, at this process's
    priority."""
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float,
           stream: str = "stdout") -> str:
    """The standard output (or error) of a started subprocess, which must
    exit with 0 within ``timeout`` seconds (it is killed otherwise)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out + err
    return out if stream == "stdout" else err


def run_beside(run: Run, fn) -> tuple:
    """(``fn()``, the output of the started reference ``run``): ``fn``
    runs in this process, beside the reference where it runs live (its
    recording, where that matches, is read at once); a live run is killed
    if ``fn`` raises."""
    try:
        out = fn()
    except BaseException:
        run.kill()
        raise
    return out, run.output()


def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def json_fields(*names) -> str:
    """A pattern of the JSON fields ``names`` with their numbers, for
    ``Reference.varies``."""
    return rf'"({"|".join(map(re.escape, names))})": (-?[\d.]+(e-?\d+)?|NaN)'
