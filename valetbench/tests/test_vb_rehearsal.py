"""A CPU rehearsal of each cell at a reduced size through the harness's
own run, and the refusals of ``run.py``."""
import json
import shutil
import subprocess
import sys

import pytest

from valetbench.harness.runner import metric_module
from valetbench.harness.spec import ROOT, load_json
from vbtiny import rehearse, tiny_cell

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct_and_reports_no_device_metric(workload):
    cell = tiny_cell(workload)
    out = rehearse(cell)
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["memory_peak_bytes"] is None
    for name in out["metrics"]:
        assert not metric_module(name).DEVICE
    assert list(out)[-1] == "checked"
    assert out["checked"]["max_logit_gap"]["value"] <= out["checked"]["max_logit_gap"]["limit"]


def test_rehearsal_under_pressure_pauses_and_restores():
    out = rehearse(tiny_cell("granite-3-8b.chat.pressure"), trace=True)
    assert set(out["metrics"]) == {"pauses_per_ktok", "streamed_share"}
    assert out["metrics"]["pauses_per_ktok"]["value"] > 0
    assert 0 <= out["metrics"]["streamed_share"]["value"] <= 100


def run_py(cwd, *args):
    return subprocess.run([sys.executable, "valetbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    r = run_py(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "valetbench", tmp_path / "valetbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = load_json(ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = metric_module(m["name"])
        assert callable(mod.read) and isinstance(mod.DEVICE, bool)
    for w in bench["workloads"]:
        assert (ROOT / "valetbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "valetbench" / "limits" / f"{w['name']}.json").exists()
    json.dumps(bench)
