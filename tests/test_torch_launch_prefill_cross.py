"""The port's sharded prefill against the reference's (see
``test_torch_launch_prefill.py``) for the cross-attention kinds, f32:

* reduced whisper-large-v3 made MHA (4 heads, 4 KV heads) at model 8: the
  heads do not divide it, so q, k and v are zero-padded to 8 heads, one
  per rank, and the padded heads' zero outputs are sliced off; encoder
  and decoder sequence-parallel (8 frames, a prompt of 13 tokens);
* reduced whisper (GQA) and llama-3.2-vision-11b (its cross-attention
  gates opened) on a 2x2 mesh, prompts of 15 tokens (S % 2 != 0).

The last position's logits within 1e-5, replicas bit-equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="whisper-mha", arch="whisper-large-v3", mesh=(1, 8), batch=2,
         seq=13, cfg=dict(n_kv_heads=4)),
    dict(tag="whisper", arch="whisper-large-v3", mesh=(2, 2), batch=4, seq=15),
    dict(tag="llama-vision", arch="llama-3.2-vision-11b", mesh=(2, 2), batch=4,
         seq=15),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_prefill(CASES, tmp_path_factory.mktemp("launch_prefill_cross"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_prefill_logits_match_reference(runs, tag):
    want, got = runs[tag]
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


def test_mha_case_pads_heads():
    cfg = lp.case_config(CASES[0])
    mp = CASES[0]["mesh"][1]
    assert cfg.n_heads == cfg.n_kv_heads and cfg.n_heads % mp
    assert lp.seq_parallel_rule(cfg, mp)
