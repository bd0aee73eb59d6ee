"""The port's serving engine against the JAX engine for infiniswap (it
deletes preempted pages and re-prefills on resume): the same tokens and the
same ``EngineStats`` under pool pressure (reduced granite-3-8b, CPU, f32)."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import assert_same_engines, both, make_setup  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    return make_setup("granite-3-8b", [8] * 6)


@pytest.mark.parametrize("policy", ["infiniswap"])
def test_baseline_tokens_and_stats_match_reference(setup, policy):
    (ref_outs, ref_eng), (outs, eng) = both(setup, policy, 10)
    assert outs == ref_outs, f"{policy} diverged from the JAX engine"
    assert eng.stats.pauses > 0
    assert_same_engines(ref_eng, eng)
    assert eng.stats.recomputes > 0 and eng.stats.deleted_pages > 0
