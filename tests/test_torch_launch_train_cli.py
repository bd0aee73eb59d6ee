"""The training launcher (``python -m repro_torch.launch.train``) on the
CPU against the reference's (``repro.launch.train.main``) on the same
arguments: reduced gemma3-4b for 12 steps, warmup 10, the history at
``fit``'s default of every tenth step and the last, the reference's
weights (its ``init_params(PRNGKey(0))``, carried over through
``bridge``), with a checkpoint written through ``ValetCheckpointer``; and
``--dryrun``: one rank's train cell (every microbatch, the backward and
the AdamW update) on the meta device, an ``ok`` record, exit 0."""
import ast
import json
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

ARGS = ["--arch", "gemma3-4b", "--local", "--steps", "12", "--seq-len", "32"]


def _history(text):
    return [ast.literal_eval(line) for line in text.splitlines()
            if line.startswith("{")]


def test_local_run_trains_and_checkpoints(monkeypatch, tmp_path, capsys):
    """Each history entry's loss, grad norm and lr within the f32 limit of
    ``test_torch_train.py::test_fit_history_matches`` (1e-4 relative: the
    steps compound)."""
    from repro.configs import get_arch as ref_get_arch
    from repro.configs import reduced as ref_reduced
    from repro.launch import train as ref_train
    from repro.models import transformer as ref_T
    from repro_torch import bridge, optim
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.train import ValetCheckpointer

    monkeypatch.setattr(sys, "argv", ["train"] + ARGS
                        + ["--ckpt-dir", str(tmp_path / "reference")])
    assert ref_train.main() == 0
    want = _history(capsys.readouterr().out)

    numpy_params = jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(0), ref_reduced(ref_get_arch("gemma3-4b"))))
    monkeypatch.setattr(T, "init_params",
                        lambda cfg, generator=None, device="cpu", **kw:
                        bridge.to_torch(numpy_params, device))
    ckpt = tmp_path / "port"
    assert train.main(ARGS + ["--device", "cpu", "--ckpt-dir", str(ckpt)]) == 0
    got = _history(capsys.readouterr().out)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 10, 11]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)
    params = T.init_params(reduced(ARCHS["gemma3-4b"]), generator=None,
                           device="meta")
    like = {"params": params, "opt": optim.init(params)}
    step, tree = ValetCheckpointer(str(ckpt)).restore(tree_like=like)
    assert step == 12 and int(tree["opt"].step) == 12
    assert tree["params"]["embed"].shape == tuple(params["embed"].shape)


def test_dryrun_writes_an_ok_record(monkeypatch, tmp_path):
    """The launcher's wiring on a reduced granite-3-8b and a train shape of
    16 x 64 tokens (the full ``train_4k`` cell takes minutes on meta): one
    microbatch on rank 0 of 16x16."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs, train
    small = reduced(ARCHS["granite-3-8b"])
    shape = ShapeConfig("train_4k", seq_len=64, global_batch=16, kind="train")
    for mod in (dryrun, specs):
        monkeypatch.setattr(mod, "get_arch", lambda name: small)
        monkeypatch.setattr(mod, "get_shape", lambda name: shape)
    monkeypatch.setattr(dryrun, "_artifact_dir", lambda: str(tmp_path))
    assert train.main(["--arch", "granite-3-8b", "--dryrun"]) == 0
    rec = json.loads((tmp_path / "single" / "granite-3-8b__train_4k.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["meta"]["microbatches"] == "1"
    mem = rec["memory"]
    # params and the AdamW state come back: every byte but the tokens' and
    # the labels' (one microbatch of one row of 64 int32 each) is aliased
    assert mem["alias_bytes"] == mem["argument_bytes"] - 2 * 64 * 4
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["roofline"]["flops_per_chip"] > 0
