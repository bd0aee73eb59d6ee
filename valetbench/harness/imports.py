"""What the benchmark may not load.

``scan`` walks the imports of every module under ``valetbench/`` (by their
source, without importing them) and rejects ``jax``, ``jaxlib``, ``flax``,
the JAX package ``repro`` and the old ``benchmarks`` folder, each compared
by its whole top-level name (``repro_torch`` starts with ``repro`` and is
allowed); modules under ``valetbench/reference/`` also reject the port,
``repro_torch``.  ``loaded`` reads ``sys.modules`` of a running process.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def top(name: str) -> str:
    return name.split(".", 1)[0]


def imported_names(path: Path) -> List[str]:
    """Every module name a source file imports, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") ==
              "import_module" and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def scan(root: Path = HERE) -> List[str]:
    """(file: name) for every forbidden import under ``root``."""
    bad = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        banned = FORBIDDEN_IN_REFERENCE if rel.parts[0] == "reference" else FORBIDDEN
        for name in imported_names(path):
            if top(name) in banned:
                bad.append(f"{rel}: {name}")
    return bad


def loaded() -> List[str]:
    """The forbidden top-level names in ``sys.modules``."""
    return sorted({top(m) for m in sys.modules} & FORBIDDEN)
