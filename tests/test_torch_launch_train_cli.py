"""The training launcher (``python -m repro_torch.launch.train``) on the
CPU: reduced gemma3-4b for 5 steps, whose loss falls, with a checkpoint
written through ``ValetCheckpointer`` into the given directory; and
``--dryrun``, which waits for ROADMAP item 13d."""
import ast

import pytest

pytest.importorskip("torch")


def test_local_run_trains_and_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train
    from repro_torch.train import ValetCheckpointer
    assert train.main(["--arch", "gemma3-4b", "--local", "--steps", "5",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    hist = [ast.literal_eval(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [h["step"] for h in hist] == list(range(5))
    assert hist[-1]["loss"] < hist[0]["loss"]
    from repro_torch import optim
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import transformer as T
    params = T.init_params(reduced(ARCHS["gemma3-4b"]), generator=None,
                           device="meta")
    like = {"params": params, "opt": optim.init(params)}
    step, tree = ValetCheckpointer(str(tmp_path)).restore(tree_like=like)
    assert step == 5 and int(tree["opt"].step) == 5
    assert tree["params"]["embed"].shape == tuple(params["embed"].shape)


def test_dryrun_waits_for_13d():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="13d"):
        train.main(["--arch", "granite-3-8b", "--dryrun"])
