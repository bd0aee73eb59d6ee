"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports ``jax`` or the reference package ``repro``, the port's serving
entry point, control plane and trace generators import (and the ML trace,
which reads the config zoo, runs) with both made unimportable, and the port
exports every public name of the reference's ``core`` and ``data``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax_or_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.serve\n"
            "import repro_torch.kernels.ops, repro_torch.bridge\n"
            "import repro_torch, repro_torch.core, repro_torch.data\n"
            "import repro_torch.data.workloads\n"
            "repro_torch.data.ml_trace(repro_torch.data.MLTraceConfig(\n"
            "    total_pages=64, n_steps=1))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["repro", "repro.core", "repro.data"])
def test_port_exports_every_reference_name(module):
    """``device_ops`` is skipped: the port's data plane takes torch tensors
    and its signatures differ by design."""
    import importlib
    ref = importlib.import_module(module)
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    names = getattr(ref, "__all__", None) or \
        [n for n in vars(ref) if not n.startswith("_")]
    missing = [n for n in names if n != "device_ops" and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
