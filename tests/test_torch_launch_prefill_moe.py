"""The port's sharded prefill against the reference's (see
``test_torch_launch_prefill.py``) for the MoE archs, f32: expert
parallelism over model 4 (reduced deepseek-moe-16b: 4 routed experts and 12
padding ones, 4 a rank, plus a shared expert cut on d_ff) and 2x2 (reduced
qwen2-moe-a2.7b), and deepseek at capacity factor 0.5 on 2x2, where each
rank's dispatch keeps at most ``e_local * cap`` of its sorted entries and
every expert ``cap`` of them, so tokens drop.  Each rank's capacity comes
from its own rows (half the batch), not the global batch.  At model 3 a
16-expert table does not divide the axis: it stays whole, is padded to 18
and each rank takes its 6 (as every other weight of the reduced config,
attention runs whole).  The last position's logits within 1e-5, replicas
bit-equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="deepseek", arch="deepseek-moe-16b", mesh=(1, 4), batch=2, seq=14),
    dict(tag="deepseek-lowcap", arch="deepseek-moe-16b", mesh=(2, 2), batch=4,
         seq=24, cfg=dict(moe=dict(capacity_factor=0.5))),
    dict(tag="qwen", arch="qwen2-moe-a2.7b", mesh=(2, 2), batch=4, seq=15),
    dict(tag="deepseek-ep3", arch="deepseek-moe-16b", mesh=(1, 3), batch=2, seq=11,
         cfg=dict(moe=dict(n_experts=16))),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_prefill(CASES, tmp_path_factory.mktemp("launch_prefill_moe"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_prefill_logits_match_reference(runs, tag):
    want, got = runs[tag]
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


def test_low_capacity_case_drops():
    """At capacity factor 0.5 a data rank's 48 rows route 96 entries to 4
    experts with a capacity of 12 each: at least half of them drop (the
    global batch's 96 rows would give a capacity of 24)."""
    from repro_torch.models.moe import capacity
    case = CASES[1]
    cfg = lp.case_config(case)
    t = case["batch"] // case["mesh"][0] * case["seq"]
    cap = capacity(t, cfg.moe)
    assert cap * cfg.moe.n_experts < t * cfg.moe.top_k


def test_model_3_case_pads_the_expert_table():
    from repro_torch.models.moe import padded_experts
    cfg = lp.case_config(CASES[3])
    assert padded_experts(cfg.moe) % 3 and cfg.n_heads % 3


def test_expert_table_past_the_pad_is_refused():
    """With 4 experts in a table of 16 at model 3 each rank would take 2 of
    a table padded to 6, short of 16: the reference's ``shard_map`` refuses
    it, and so does the port."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    cfg = lp.case_config(dict(arch="deepseek-moe-16b"))
    params = moe.init_moe(cfg.d_model, cfg.moe, 1, generator=torch.Generator(),
                          device="cpu")
    params = {k: (v[0] if torch.is_tensor(v) else {n: w[0] for n, w in v.items()})
              for k, v in params.items()}
    mesh = Mesh((1, 3), ("data", "model"))
    mesh.coords = {"data": 0, "model": 0}          # a layout at rank 0
    with pytest.raises(ValueError, match="experts"):
        moe.moe_ffn(params, torch.zeros((1, 4, cfg.d_model)), cfg.moe, mesh=mesh)
