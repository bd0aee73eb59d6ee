"""The port's sharded prefill against the reference's (see
``test_torch_launch_prefill.py``) for the SSM and hybrid kinds, f32:

* reduced mamba2-2.7b at model 4 (8 SSD heads: each rank scans its 2),
  sequence-parallel, a prompt of 22 tokens (S % 4 != 0, and padded to the
  scan's chunk of 8);
* mamba2 at d_model 48 on model 4: 6 SSD heads do not divide it, so each
  rank scans every head's block of 4 of head_dim 16 while ``wx`` is cut in
  blocks of 1.5 heads (hymba-1.5b's case at model 4);
* reduced hymba-1.5b at model 8: 4 attention heads do not divide it and
  it is GQA, so attention runs whole on every rank and sequence
  parallelism is off; its 8 SSD heads split one per rank;
* mamba2 with 2 B/C groups at model 4: a rank's 2 heads read one group,
  taken per head.

The last position's logits within 1e-5, replicas bit-equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="mamba2", arch="mamba2-2.7b", mesh=(2, 4), batch=4, seq=22),
    dict(tag="mamba2-hd", arch="mamba2-2.7b", mesh=(1, 4), batch=2, seq=16,
         cfg=dict(d_model=48)),
    dict(tag="hymba", arch="hymba-1.5b", mesh=(1, 8), batch=2, seq=20),
    dict(tag="mamba2-g2", arch="mamba2-2.7b", mesh=(1, 4), batch=2, seq=16,
         cfg=dict(ssm=dict(n_groups=2))),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_prefill(CASES, tmp_path_factory.mktemp("launch_prefill_ssm"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_prefill_logits_match_reference(runs, tag):
    want, got = runs[tag]
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


@pytest.mark.parametrize("tag,layout,sp", [("mamba2", "heads", True),
                                           ("mamba2-hd", "head_dim", True),
                                           ("hymba", "heads", False),
                                           ("mamba2-g2", "heads", True)])
def test_cases_take_the_branches_they_name(tag, layout, sp):
    from repro_torch.models.ssm import ssm_dims, tp_layout
    case = next(c for c in CASES if c["tag"] == tag)
    cfg, mp = lp.case_config(case), case["mesh"][1]
    d_inner, n_heads, _ = ssm_dims(cfg.d_model, cfg.ssm)
    assert tp_layout(n_heads, cfg.ssm.head_dim, mp) == layout
    assert lp.seq_parallel_rule(cfg, mp) == sp
    if layout == "head_dim":      # wx's blocks are not whole heads
        assert (d_inner // mp) % cfg.ssm.head_dim
