"""Record the JAX reference runs that the twin tests read.

    python tests/record_reference_runs.py [key ...]

Runs each named reference (every declared one without names) live, as
the tests would run it (JAX on the CPU, the suite's ``XLA_FLAGS``), and
rewrites its recording under ``tests/data/reference_runs/``: the stream
its tests read, the files it writes, and its fingerprint
(``tool_twins.fingerprint``). Without names it also removes recordings
that no test declares. Four run at once.
"""

from __future__ import annotations

import importlib.metadata as md
import json
import re
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS), str(TESTS.parent)]

import tool_twins  # noqa: E402
from tool_twins import ROOT, Reference  # noqa: E402

# The program runs under an audit hook that lists every file it opens or
# imports and the file of each top-level module it imports.
AUDIT = """
import atexit, json, os, sys
_audit_seen = set()
def _audit_hook(event, args):
    if event in ("open", "ctypes.dlopen") and isinstance(args[0], str):
        _audit_seen.add(os.path.abspath(args[0]))
sys.addaudithook(_audit_hook)
def _audit_dump():
    mods = list(sys.modules.items())
    files = _audit_seen | {{os.path.abspath(m.__file__) for _, m in mods
                           if getattr(m, "__file__", None)}}
    top = {{n.split(".")[0] for n, _ in mods}}
    with open({listing!r}, "w") as f:
        json.dump(dict(files=sorted(files), modules={{
            n: getattr(sys.modules.get(n), "__file__", None)
            for n in top}}), f)
atexit.register(_audit_dump)
"""
# Then it runs as ``python -c code`` or ``python script argv`` would.
RUN_CODE = """
sys.argv = ["-c"]
exec(compile({code!r}, "<string>", "exec"), sys.modules["__main__"].__dict__)
"""
RUN_SCRIPT = """
import runpy
sys.argv = {argv!r}
sys.path[0] = os.path.dirname(sys.argv[0])
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def repo_files(path: str) -> list:
    """The repository files that ``path``'s content comes from (a
    compiled module's source, a built library's sources), none outside
    the repository's sources."""
    p = Path(path)
    if p.parent.name == "__pycache__":
        p = p.parent.parent / (p.name.split(".")[0] + ".py")
    try:
        rel = p.relative_to(ROOT)
    except ValueError:
        return []
    if (rel.parts[0] == ".git" or p.is_relative_to(tool_twins.RECORDINGS)
            or not p.is_file()):
        return []
    if p.suffix == ".so":
        return [str(q.relative_to(ROOT)) for q in sorted(p.parent.iterdir())
                if q.suffix in (".cpp", ".c", ".h") or q.name == "Makefile"]
    return [str(rel)]


def remove(key: str):
    """Delete the recording of ``key``, its files included."""
    recordings = tool_twins.RECORDINGS
    if (recordings / key).is_dir():
        shutil.rmtree(recordings / key)
    for f in recordings.glob(f"{key}.*"):
        f.unlink()


def copy_output(src: Path, dst: Path, out: Path):
    """A program's output file into its recording: an NPZ with its arrays
    compressed (the same arrays, bit for bit), a text file with the root
    and ``out`` as their marks."""
    if src.suffix == ".npz":
        import numpy as np

        with np.load(src) as d:
            np.savez_compressed(dst, **{k: d[k] for k in d.files})
    else:
        dst.write_text(tool_twins.marked(src.read_text(), out))


def record(ref: Reference, log=print) -> dict:
    """Run ``ref`` live under the audit hook and write its recording."""
    with tempfile.TemporaryDirectory(prefix=f"{ref.key}-") as tmp:
        out, listing = Path(tmp) / "out", Path(tmp) / "listing.json"
        out.mkdir()
        cmd, env = ref.command(out)
        body = (RUN_CODE.format(code=cmd[2]) if cmd[1] == "-c" else
                RUN_SCRIPT.format(argv=cmd[1:]))
        t0 = time.time()
        proc = tool_twins.start([sys.executable, "-c", AUDIT.format(
            listing=str(listing)) + body], env)
        text = tool_twins.finish(proc, ref.timeout, ref.stream)
        wall = time.time() - t0
        seen = json.loads(listing.read_text())
        owners = md.packages_distributions()
        dists = tool_twins.versions(sorted({
            d for name, f in seen["modules"].items()
            if f and re.search(r"[/\\](site|dist)-packages[/\\]", f)
            for d in owners.get(name, ())}))
        sources = {r: tool_twins.file_sha(r) for r in sorted(
            {r for f in seen["files"] for r in repo_files(f)}
            | set(tool_twins.package_sources()))}
        meta = dict(key=ref.key, program=ref.program(), stream=ref.stream,
                    files=list(ref.files), sources=sources, versions=dists,
                    fingerprint=tool_twins.fingerprint(ref.program(),
                                                       sources, dists),
                    seconds=round(wall, 1))
        remove(ref.key)
        recordings = tool_twins.RECORDINGS
        recordings.mkdir(parents=True, exist_ok=True)
        (recordings / f"{ref.key}.{ref.stream}").write_text(
            tool_twins.marked(text, out))
        if ref.files:
            (recordings / ref.key).mkdir()
            for f in ref.files:
                copy_output(out / f, recordings / ref.key / f, out)
        ref.meta_path.write_text(json.dumps(meta, indent=1) + "\n")
    log(f"{ref.key}: {wall:.1f} s, {len(sources)} sources")
    return meta


def main(keys: list) -> int:
    import conftest  # noqa: F401  (the suite's XLA_FLAGS and JAX config)

    refs = {k: ref for k, (ref, _) in tool_twins.declared().items()}
    unknown = sorted(set(keys) - set(refs))
    if unknown:
        print("no reference declares:", ", ".join(unknown))
        return 2
    if not keys:
        for meta in tool_twins.RECORDINGS.glob("*.json"):
            if meta.stem not in refs:
                print("removing", meta.stem)
                remove(meta.stem)
    chosen = [refs[k] for k in (keys or sorted(refs))]
    # The longest first; reading each result raises a run's failure.
    with ThreadPoolExecutor(4) as pool:
        for _ in pool.map(record, sorted(chosen, key=lambda r: -r.timeout)):
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
