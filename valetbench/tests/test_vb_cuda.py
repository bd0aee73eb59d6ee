"""The harness on the card at a reduced size: the kernels, the trace and
every device metric.  Marked ``cuda``; it skips without a card (decided
inside the test)."""
import pytest
import torch

from vbtiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["granite-3-8b.chat.pressure",
                                      "hymba-1.5b.long.pressure"])
def test_tiny_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from valetbench.harness.runner import run_cell
    cell = tiny_cell(workload)
    out = run_cell(cell, 5, 2.0, True, "cuda", time.perf_counter(), log=lambda *a: None)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    for name in ("paged_attn_roofline", "flash_attn_roofline", "device_idle_share"):
        assert 0 < out["metrics"][name]["value"] <= 105
    assert out["breakdown"]["device_ops"]
