"""The port's sharded prefill (``launch/specs.build_prefill_cell``: the
sharded ``prefill_logits``) on gloo ranks against the reference's sharded
``prefill_logits`` on an Auto mesh of fake CPU devices, f32, for the
attention kinds:

* reduced granite-3-8b at model 4 (2 KV heads: K/V whole and repeated to
  the query heads), sequence-parallel by the cell's rule and, on the same
  mesh, with ``seq_parallel`` off; a prompt of 13 tokens (S % 4 != 0);
* reduced gemma3-4b (a sliding-window and a global layer) on a 2x2 mesh.

The last position's logits within 1e-5, replicas bit-equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="granite-sp", arch="granite-3-8b", mesh=(2, 4), batch=4, seq=13),
    dict(tag="granite-nosp", arch="granite-3-8b", mesh=(2, 4), batch=4, seq=13,
         sp=False),
    dict(tag="gemma3", arch="gemma3-4b", mesh=(2, 2), batch=4, seq=24),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_prefill(CASES, tmp_path_factory.mktemp("launch_prefill"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_prefill_logits_match_reference(runs, tag):
    want, got = runs[tag]
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


def test_cases_take_the_branches_they_name():
    """granite's 2 KV heads do not divide model 4, its 4 query heads do;
    the rule turns sequence parallelism on for it."""
    cfg = lp.case_config(CASES[0])
    assert cfg.n_heads % 4 == 0 and cfg.n_kv_heads % 4
    assert lp.seq_parallel_rule(cfg, 4) and CASES[0]["seq"] % 4
