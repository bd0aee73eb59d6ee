"""No benchmark module imports JAX, the JAX package ``repro`` (whole
top-level name) or the old ``benchmarks`` folder; the reference does not
import the port either."""
from valetbench.harness import imports


def test_no_forbidden_import_under_valetbench():
    assert imports.scan() == []


def test_the_scan_catches_each_kind(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                                   "import repro_torch\nimport reprox\n")
    (tmp_path / "b.py").write_text("def f():\n    import benchmarks.run\n"
                                   "    importlib.import_module('flax')\n")
    (tmp_path / "reference" / "c.py").write_text("from repro_torch.models import decode\n")
    bad = imports.scan(tmp_path)
    assert bad == ["a.py: jax.numpy", "a.py: repro.core", "b.py: benchmarks.run",
                   "b.py: flax", "reference/c.py: repro_torch.models"]


def test_loaded_compares_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in imports.loaded()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in imports.loaded()
