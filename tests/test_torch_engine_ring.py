"""The port's serving engine on a sliding-window arch (reduced gemma3-4b:
ring layers beside a paged global layer) against the JAX engine, with
prompts past the 16-token window so the ring wraps, under pool pressure."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import assert_same_engines, both, make_setup  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    return make_setup("gemma3-4b", [20] * 5)


@pytest.fixture(scope="module")
def unpressured(setup):
    return both(setup, "valet", 64)


@pytest.mark.parametrize("zero", [True, False])
def test_ring_engine_matches_reference_under_pressure(setup, unpressured,
                                                      zero):
    (ref_outs, ref_eng), (outs, eng) = both(setup, "valet", 14,
                                            zero_restore=zero)
    assert outs == ref_outs
    assert_same_engines(ref_eng, eng)
    assert eng.stats.pauses > 0
    assert outs == unpressured[1][0]


def test_ring_engine_unpressured_matches_reference(unpressured):
    (ref_outs, ref_eng), (outs, eng) = unpressured
    assert outs == ref_outs
    assert_same_engines(ref_eng, eng)
