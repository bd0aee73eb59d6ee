"""The work counts against the kernel table's bounds (PERF.md, section 6),
and the model FLOPs against the parameter count."""
import numpy as np
import pytest

from valetbench.harness.spec import HERE, load_json
from valetbench.harness.weights import n_params
from valetbench.harness.work import (Model, band_pairs, bound_s, flash_call,
                                     paged_call, ssd_call)


def test_paged_granite_decode_bound():
    # chip_smoke's case: B 8, 32/8 heads, D 128, page 16, rows 1..600 from
    # seed 1 (row 0 the longest), a -1 hole at row 1's second page, bf16 q,
    # f32 pool, 40 + 2 pages a row in the table
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 601, size=8).astype(np.int32)
    lengths[0] = 600
    live = [int(n) for n in lengths]
    live[1] -= min(16, live[1] - 16)                  # the hole's tokens
    n_bytes, ops = paged_call(live, 32, 8, 128, 16, "bfloat16", "float32")
    # chip_smoke counts the whole table (8 x 40 int32) where the benchmark
    # counts the rows' pages
    table = 8 * 40 * 4 - 4 * sum(-(-n // 16) for n in live)
    t, by = bound_s(n_bytes + table, ops, "float32")
    assert by == "bytes"
    assert round(1e3 * t, 4) == 0.0076


def test_flash_granite_prefill_bound():
    t, by = bound_s(*flash_call(512, 32, 8, 128, 0, "bfloat16"), "bfloat16")
    assert by == "bytes" and round(1e3 * t, 4) == 0.0031


def test_ssd_mamba2_bound():
    t, by = bound_s(*ssd_call(1024, 80, 64, 1, 128, 256, "bfloat16"), "bfloat16")
    assert by == "bytes" and round(1e3 * t, 4) == 0.0104


def test_ssd_ops_match_whole_chunks_and_count_a_short_last_one():
    _, whole = ssd_call(512, 4, 8, 1, 4, 256, "bfloat16")
    _, half = ssd_call(256, 4, 8, 1, 4, 256, "bfloat16")
    assert whole == 2 * half
    _, ragged = ssd_call(300, 4, 8, 1, 4, 256, "bfloat16")
    _, tail = ssd_call(44, 4, 8, 1, 4, 256, "bfloat16")
    assert ragged == half + tail


@pytest.mark.parametrize("s, w, want", [(5, 0, 15), (5, 3, 6 + 3 + 3), (3, 8, 6)])
def test_band_pairs(s, w, want):
    i = np.arange(s)
    mask = i[None, :] <= i[:, None]
    if w:
        mask &= i[None, :] > i[:, None] - w
    assert band_pairs(s, w) == want == int(mask.sum())


@pytest.mark.parametrize("name", ["granite-3-8b", "hymba-1.5b"])
def test_model_flops_are_twice_the_matmul_parameters_and_more(name):
    cfg = load_json(HERE / "configs" / f"{name}.json")
    m = Model(cfg)
    dense = 2 * m.matmul_params()
    # every layer's products: all parameters but the embedding, the
    # unembedding and the norms, conv and SSM scalars
    other = n_params(cfg) - 2 * 256 * -(-cfg["vocab_size"] // 256) * cfg["hidden_size"]
    assert 0.99 * other < dense / 2 <= other
    assert m.token_flops(1) > dense
    assert m.decode_flops(100) - m.token_flops(100) == 2 * cfg["hidden_size"] * cfg["vocab_size"]
    assert m.prefill_flops(1) == pytest.approx(m.decode_flops(1))


def test_hymba_layers_and_kernel_bounds():
    m = Model(load_json(HERE / "configs" / "hymba-1.5b.json"))
    assert m.paged_layers == 3 and m.windows.count(1024) == 29
    assert m.ssd_bound([2000]) > 0 and m.flash_bound([2000]) > 0
    g = Model(load_json(HERE / "configs" / "granite-3-8b.json"))
    assert g.paged_layers == 40 and g.ssd_bound([2000]) == 0.0
    assert g.paged_bound([], 16) == 0.0
