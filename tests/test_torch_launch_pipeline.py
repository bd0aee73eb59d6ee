"""The port's 2-stage GPipe step (``launch/pipeline.py``) on 4 gloo ranks,
pod 2 x model 2, against the reference's single-device ``make_train_step``
with the pipeline's semantics: reduced granite-3-8b (one layer a stage),
bf16 compute, remat, two microbatches, ``AdamWConfig()``, labels >= 0
(the pipeline's NLL tail does not mask).  The reference's own GPipe step
aborts in XLA under jax 0.9 (ROADMAP, "Reference facts"), so only its
placements and args are held, and they need no jit.

Limits: loss and grad norm within 2e-2 relative (bf16); params within
2.5 lr absolute (a sign flip of a near-zero bf16 gradient moves a leaf by
2 lr at step 1)."""
import ast

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

CASE = dict(tag="granite", arch="granite-3-8b")
REL = 2e-2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return lp.run_pipeline(CASE, tmp_path_factory.mktemp("launch_pipeline"))


def test_loss_and_grad_norm_match_one_device(run):
    ref, ranks = run
    for name in ("loss", "grad_norm"):
        vals = {float(r[name]) for r in ranks}
        assert len(vals) == 1, (name, vals)
        want = float(ref[name])
        assert abs(vals.pop() - want) <= REL * abs(want), (name, want)


def test_params_match_one_device(run):
    from repro_torch import bridge
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.pipeline import pp_specs
    ref, ranks = run
    cfg = lp.case_config(CASE)
    layout = Mesh(lp.PP_MESH, ("pod", "data", "model"))
    params0 = lp.unflatten(ref, "params0")
    got = bridge.unshard_to_numpy([lp.unflatten(r, "params") for r in ranks],
                                  pp_specs(cfg, layout, params0), layout)
    lr = float(ref["lr"])
    assert all(float(r["lr"]) == pytest.approx(lr, rel=1e-6) for r in ranks)
    want = lp.flatten(lp.unflatten(ref, "params"), "p")
    got = lp.flatten(got, "p")
    assert want.keys() == got.keys()
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        assert err <= 2.5 * lr, (key, err, lr)


def test_hops_are_the_schedules(run):
    """M + 1 forward hops, and M backward ones (the drain tick's hop feeds
    nothing), on every rank."""
    _, ranks = run
    assert [int(r["hops"]) for r in ranks] == [2 * lp.PP_MICRO + 1] * len(ranks)


def test_placements_and_args_equal_the_reference(run):
    """The placements and args of ``make_pp_train_step`` (leaves in
    ``jax.tree`` order: the pods' layer stacks, replicated embedding,
    moments as the params)."""
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.pipeline import make_pp_train_step
    ref, _ = run
    _, args, ins = make_pp_train_step(
        lp.case_config(CASE), ShapeConfig(**lp.PP_SHAPE),
        Mesh(lp.PP_MESH, ("pod", "data", "model")), n_micro=lp.PP_MICRO)
    assert bridge.tree_flatten(list(ins), is_leaf=bridge.is_spec)[0] == \
        ast.literal_eval(str(ref["ins"]))
    got = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for a in bridge.tree_flatten(args)[0]]
    assert got == ast.literal_eval(str(ref["args"]))
    assert all(a.device.type == "meta" for a in bridge.tree_flatten(args)[0])
