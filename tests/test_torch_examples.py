"""The port's examples (``examples/*_torch.py``) on the CPU against the
reference examples' stdout: each port example is run with the reference's
weights (its ``init_params(PRNGKey(0))``, carried over through ``bridge``),
and each reference example in a subprocess, all three started at once.
Held: the policy table and its ``exact`` column line for line; the
quickstart's losses (to the printed rounding plus the f32 limit of
``test_fit_history_matches``), pressure counters and tokens; the fault
example's restore, resume losses, elastic plan and recovered/lost pages.
Wall-clock numbers (the checkpoint's staging time) are left out."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "policy_comparison", "fault_tolerance")
ARCH = {"quickstart": "gemma3-4b", "policy_comparison": "granite-3-8b",
        "fault_tolerance": "phi3-mini-3.8b"}
SECONDS = 240


@pytest.fixture(scope="module")
def reference_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def reference_stdout(reference_runs, name):
    out, err = reference_runs[name].communicate(timeout=SECONDS)
    assert reference_runs[name].returncode == 0, err[-4000:]
    return out.splitlines()


def run_port(name, capsys):
    """The port example's ``run`` on the reference's weights, on the CPU:
    (its result, its stdout lines)."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import reduced as ref_reduced
    from repro.models import transformer as ref_T
    from repro_torch import bridge
    from repro_torch.configs import ARCHS, reduced
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    params = bridge.to_torch(jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(0), ref_reduced(REF_ARCHS[ARCH[name]]))), "cpu")
    capsys.readouterr()
    result = module.run(params, reduced(ARCHS[ARCH[name]]), "cpu")
    return result, capsys.readouterr().out.splitlines()


def _floats(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_policy_comparison_prints_the_reference_table(reference_runs, capsys):
    results, got = run_port("policy_comparison", capsys)
    want = reference_stdout(reference_runs, "policy_comparison")
    assert got == want
    assert [line.split()[-1] for line in got[1:4]] == ["True"] * 3
    assert all(outs == results["valet"][0] for outs, _ in results.values())


def test_quickstart_prints_the_reference_facts(reference_runs, capsys):
    (hist, full, tight, stats), got = run_port("quickstart", capsys)
    want = reference_stdout(reference_runs, "quickstart")
    assert got[0] == want[0] + " device=cpu"
    steps = [line for line in want if line.startswith("step")]
    assert len(steps) == len(hist) == 4
    for line, h in zip(steps, hist):
        assert int(line.split()[1]) == h["step"]
        assert abs(h["loss"] - _floats(line)[0]) <= 5e-4 + 1e-4 * abs(h["loss"])
    tail = want[len(steps) + 1:]
    assert got[len(steps) + 1:] == tail
    assert "outputs identical under pressure: True" in tail and full == tight
    assert stats.pauses > 0


def test_fault_tolerance_prints_the_reference_facts(reference_runs, capsys):
    res, got = run_port("fault_tolerance", capsys)
    want = reference_stdout(reference_runs, "fault_tolerance")
    assert [line.split()[0] for line in got] == [line.split()[0] for line in want]
    # the staging time is wall clock: only its line's shape is held
    assert re.fullmatch(r"\[ckpt\] staged in \d+\.\d ms .*", got[0])
    assert got[1] == want[1] and res["exact"] and res["restore_step"] == 20
    ref_from, ref_to = _floats(want[2])
    for mine, theirs in ((res["hist"][-1]["loss"], ref_from),
                         (res["hist2"][-1]["loss"], ref_to)):
        assert abs(mine - theirs) <= 5e-4 + 1e-4 * abs(mine)
    assert got[3:] == want[3:]
    assert res["lost"] == 0 and res["recovered"] > 0
