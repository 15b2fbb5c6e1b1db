"""What the benchmark may import and read.

Top-level module names are compared whole: ``sara_tpu_torch`` begins with
``sara_tpu`` and is the program, which the harness drives; ``sara_tpu``
is the JAX package, which nothing under ``benchmark/`` may import, nor
JAX itself. The plain reference imports nothing of the program either,
and no file reads the JAX-era bench files, the smoke script, the probes or
the repository's tests."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sara_tpu"}
NOT_READ = ("bench.py", "chip_smoke", "torch_bench", "scripts/", "tests/",
            "BENCH_", "BA_BENCH_", "MULTICHIP_", "CONFIG5_")


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_nor_jax_package(path):
    assert not (_top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "sara_tpu_torch" not in names
    assert not (names & FORBIDDEN)
    assert names <= {"__future__", "math", "contextlib", "torch"}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_reads_no_file_of_the_old_benches(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            assert not any(s in node.value for s in NOT_READ), (
                path.name, node.value[:80])


def test_the_name_check_compares_whole_names():
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "sara_tpu_torch".split(".")[0] not in FORBIDDEN
