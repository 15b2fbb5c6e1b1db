"""A function that a probe of ``scripts/`` defines inside its ``main``,
compiled on its own: the probe's code as it stands, without running its
``main``. Imported by the tests and by their JAX programs alike."""

from __future__ import annotations

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


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
