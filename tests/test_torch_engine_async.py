"""The port's serving engine against the JAX engine for the valet-mass
policy and in async mode (the daemon clock and restore fences) with legacy
bulk restores: the same tokens and the same ``EngineStats`` under pool
pressure (reduced granite-3-8b, CPU, f32)."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import assert_same_engines, both, make_setup  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    return make_setup("granite-3-8b", [8] * 6)


def test_async_mode_and_legacy_restore_match_reference(setup):
    (ref_outs, ref_eng), (outs, eng) = both(setup, "valet", 10,
                                            async_mode=True, zero_restore=False)
    assert outs == ref_outs
    assert_same_engines(ref_eng, eng)
    assert eng.stats.fences > 0 and eng.stats.daemon_us > 0


def test_valet_mass_matches_reference(setup):
    (ref_outs, ref_eng), (outs, eng) = both(setup, "valet-mass", 10)
    assert outs == ref_outs
    assert_same_engines(ref_eng, eng)
    assert eng.stats.pauses > 0
