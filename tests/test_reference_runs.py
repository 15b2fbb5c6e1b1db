"""The recordings of the JAX reference runs that the twin tests read
(``tests/data/reference_runs/``, ``tool_twins.Reference``).

Each recording matches the tree as it stands (its fingerprint), its files
exist and parse, and a test reads it; a stale one is not read. And, marked
slow because it is the work the recordings save, each program run live
prints and writes what its recording holds: the same text and arrays
equal to the bit, the patterns its reference names as varying from run to
run left out.
"""

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import record_reference_runs  # noqa: E402
import tool_twins  # noqa: E402
from tool_twins import RECORD_COMMAND, RECORDINGS, marked  # noqa: E402

DECLARED = tool_twins.declared()
KEYS = sorted(set(DECLARED) | {p.stem for p in RECORDINGS.glob("*.json")})


def uses(ref, mod) -> list:
    """The functions of the module ``mod`` that read a module-level name
    bound to ``ref`` (or to a dict, list or tuple holding it)."""
    names = {n for n, v in vars(mod).items()
             if any(r is ref for r in tool_twins.held(v))}
    tree = ast.parse(Path(mod.__file__).read_text())
    return sorted(f.name for f in ast.walk(tree)
                  if isinstance(f, ast.FunctionDef)
                  and any(isinstance(n, ast.Name) and n.id in names
                          for n in ast.walk(f)))


def normalised(ref, text: str) -> str:
    """``text`` with the patterns of ``ref`` that vary from run to run
    replaced."""
    for pattern in ref.varies:
        text = re.sub(pattern, "<varies>", text)
    return text


def _read(path: Path):
    """A recorded or live output file, parsed: an NPZ's arrays, a JSON
    document."""
    if path.suffix == ".npz":
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    return json.loads(path.read_text())


@pytest.mark.parametrize("key", KEYS)
def test_recording_is_current_whole_and_read(key):
    assert key in DECLARED, (
        f"no test declares {key}; {RECORD_COMMAND} removes its recording")
    ref, module = DECLARED[key]
    why = ref.stale()
    assert why is None, f"{key} is stale ({why}): {RECORD_COMMAND} {key}"
    out = ref.recording()
    assert sorted(out.files) == sorted(ref.files)
    for path in out.files.values():
        assert _read(path), path
    assert uses(ref, module), (
        f"no function of {module.__name__} reads {key}")


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(DECLARED))
def test_recording_is_the_live_output(key, tmp_path):
    ref, _ = DECLARED[key]
    cmd, env = ref.command(tmp_path)
    live = tool_twins.finish(tool_twins.start(cmd, env), ref.timeout,
                             ref.stream)
    recorded = (RECORDINGS / f"{key}.{ref.stream}").read_text()
    assert normalised(ref, marked(live, tmp_path)) == \
        normalised(ref, recorded)
    for name, path in ref.recording().files.items():
        if path.suffix == ".npz":
            got, want = _read(tmp_path / name), _read(path)
            assert sorted(got) == sorted(want), name
            for k in want:
                assert (got[k].dtype, got[k].shape) == (
                    want[k].dtype, want[k].shape), (name, k)
                assert got[k].tobytes() == want[k].tobytes(), (name, k)
        else:
            got = marked((tmp_path / name).read_text(), tmp_path)
            assert normalised(ref, got) == normalised(
                ref, path.read_text()), name


def test_a_recording_is_read_only_while_it_matches(tmp_path, monkeypatch):
    """A program without a recording runs live; recorded, it is read from
    its recording; once a source it loaded differs from its fingerprint,
    it runs live again, and its recording is left as it was."""
    monkeypatch.setattr(tool_twins, "RECORDINGS", tmp_path / "recordings")
    ref = tool_twins.jax_reference(
        "selftest.print", f"print('printed', {tool_twins.OUT!r})", 120)
    run = ref.start(tmp_path / "live")
    assert run.proc is not None
    assert run.output().text == f"printed {tmp_path / 'live'}\n"
    assert ref.stale() == "no recording"

    record_reference_runs.record(ref, log=lambda *a: None)
    assert ref.stale() is None
    run = ref.start(tmp_path / "unused")
    assert run.proc is None
    recorded = tool_twins.RECORDINGS / "selftest.print"
    assert run.output().text == f"printed {recorded}\n"

    meta = json.loads(ref.meta_path.read_text())
    source = sorted(meta["sources"])[0]
    meta["sources"][source] = "0" * 64
    ref.meta_path.write_text(json.dumps(meta))
    assert ref.stale() == f"changed: {source}"
    run = ref.start(tmp_path / "again")
    assert run.proc is not None
    assert run.output().text == f"printed {tmp_path / 'again'}\n"
    assert json.loads(ref.meta_path.read_text()) == meta
