"""The granite-4.0-h-small cell at a CPU test's size: its configuration
file cut in width and depth as the port's tier-1 tests cut it (the
published multipliers, 12 experts of which 6 are held), run through the
harness's own run, and the reference family's layer work."""
from valetbench.harness.spec import HERE, ROOT, Cell, load_json, metrics_for
from valetbench.harness.work import Model
from vbtiny import TINY_LIMIT, rehearse, tiny_traffic
# the one cut of the configuration, shared with the port's tier-1 tests
from tests.test_torch_granite_moe_hybrid import small_config

CELL = "granite-4.0-h-small.chat.roomy128"


def tiny_cell():
    bench = load_json(ROOT / "BENCHMARK.json")
    w = [x for x in bench["workloads"] if x["name"] == CELL][0]
    traffic = tiny_traffic(w["traffic"])
    return Cell(CELL, w, small_config(), traffic, {"max_logit_gap": {"limit": TINY_LIMIT}},
                metrics_for(bench["end_to_end"], CELL), metrics_for(bench["per_layer"], CELL))


def test_rehearsal_is_correct():
    out = rehearse(tiny_cell())
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert out["checked"]["max_logit_gap"]["value"] <= TINY_LIMIT


def test_layer_work_counts_this_chips_share_of_the_experts():
    c = load_json(HERE / "configs" / "granite-4.0-h-small.json")
    m = Model(c)
    assert m.paged_layers == 4 and len(m.scans) == 36 and m.windows == [0] * 4
    d, f = 4096, 768
    per_layer_moe = d * 72 + 3 * d * 1536 + 10 * 18 * 3 * d * f // 72   # 2.5 experts
    attn = 2 * d * 4096 + 2 * d * 1024
    ssm = d * (2 * 8192 + 256 + 128) + 8192 * d
    assert m.matmul_params() == 40 * per_layer_moe + 4 * attn + 36 * ssm
