"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports ``jax`` or the reference package ``repro``, the port's serving
entry point, control plane, trace generators, optimizer and trainer import
(and the ML trace, which reads the config zoo, runs) with both made
unimportable, and the port exports every public name of the reference's
``core``, ``data``, ``optim`` and ``train``."""
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
            "import repro_torch.optim, repro_torch.train\n"
            "repro_torch.data.ml_trace(repro_torch.data.MLTraceConfig(\n"
            "    total_pages=64, n_steps=1))\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# every public name is ported (the sharded training pieces since ROADMAP
# Queue 1 item 13c)
NOT_YET = set()


@pytest.mark.parametrize("module", ["repro", "repro.core", "repro.data",
                                    "repro.optim", "repro.train"])
def test_port_exports_every_reference_name(module):
    """``device_ops`` is skipped: the port's data plane takes torch tensors
    and its signatures differ by design."""
    import importlib
    ref = importlib.import_module(module)
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    names = getattr(ref, "__all__", None) or \
        [n for n in vars(ref) if not n.startswith("_")]
    missing = [n for n in names if n != "device_ops" and n not in NOT_YET
               and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_launch_layer_imports_without_jax_or_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.launch.mesh, repro_torch.launch.serve_step\n"
            "import repro_torch.launch.specs, repro_torch.launch.serve\n"
            "import repro_torch.launch.pipeline, repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.roofline\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# what of the reference's launch layer waits, by ROADMAP item: nothing
LAUNCH_NOT_YET = {}


@pytest.mark.parametrize("module", ["repro.launch.mesh",
                                    "repro.launch.serve_step",
                                    "repro.launch.specs",
                                    "repro.launch.serve",
                                    "repro.launch.pipeline",
                                    "repro.launch.train"])
def test_port_exports_every_reference_launch_name(module):
    """Every public name a launch module of the reference defines (not the
    names it imports: ``jax``, ``P``, ...)."""
    import importlib
    ref = importlib.import_module(module)
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    names = [n for n, v in vars(ref).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == module]
    assert names
    missing = [n for n in names if n not in LAUNCH_NOT_YET
               and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


# the reference's names whose work the port does another way: the compiled
# program's HLO walk becomes the meta run's counts
REPLACED = {"HloAnalysis": "meta_counts", "analyze_hlo": "meta_counts"}


@pytest.mark.parametrize("module", ["repro.launch.dryrun", "repro.roofline"])
def test_port_exports_every_reference_name_read_from_source(module):
    """Every public function and class of the reference module, read with
    ``ast``: importing ``repro.launch.dryrun`` would set 512 fake XLA
    devices for every later test of this process."""
    import importlib
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")]
    assert names
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    missing = [n for n in names if not hasattr(port, REPLACED.get(n, n))]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_serving_engine_leaves_the_data_plane_to_its_batch():
    """``serve/engine.py`` is orchestration: the decode path, the MoE and
    the kernels are ``serve/batch.py``'s to import, and the engine names no
    cache key."""
    path = ROOT / "src" / "repro_torch" / "serve" / "engine.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    bad = {m for m in mods if m.startswith(("repro_torch.models.decode",
                                            "repro_torch.models.moe",
                                            "repro_torch.kernels"))}
    assert not bad, f"serve/engine.py imports {sorted(bad)}"
    assert "repro_torch.serve.batch" in mods
    strings = {n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    keys = strings & {"pool", "ring", "ssm", "h", "conv", "lengths", "layers"}
    assert not keys, f"serve/engine.py names the cache keys {sorted(keys)}"
