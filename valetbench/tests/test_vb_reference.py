"""The plain reference against the port's own full forward, at a reduced
size on the CPU, both in float32 on the same weights."""
import pytest
import torch

from valetbench.harness.drive import check_layout, port_arch
from valetbench.harness.weights import make_params
from valetbench.reference import dense_gqa, hybrid
from vbtiny import tiny_config


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("name, ref", [("granite-3-8b", dense_gqa),
                                       ("hymba-1.5b", hybrid)])
def test_reference_matches_the_port_forward(name, ref):
    from repro_torch.models import transformer as T
    cfg = tiny_config(name)
    params = f32(make_params(cfg, 2 ** 33 + 5, "cpu"))
    arch = port_arch(cfg)
    check_layout(cfg, arch)
    s = 37                                  # past the tiny window of 16
    toks = torch.randint(2, cfg["vocab_size"], (s,), generator=torch.Generator().manual_seed(3))
    ctx = T.ParallelCtx(remat=False, q_block=8, kv_block=8)
    with torch.no_grad():
        h, _ = T.forward_hidden(params, toks[None], arch, ctx)
        port = T.logits(params, h[0], arch, ctx)[:, : cfg["vocab_size"]]
        mine = ref.forward(params, cfg, toks, torch.arange(s))
    scale = mine.abs().max()
    assert float((port - mine).abs().max()) < 1e-5 * max(1.0, float(scale))
    assert float(scale) > 0


def test_reference_sees_the_window_and_the_global_layers():
    cfg = tiny_config("hymba-1.5b")
    params = f32(make_params(cfg, 9, "cpu"))
    toks = torch.randint(2, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(4))
    base = hybrid.forward(params, cfg, toks, torch.arange(40))
    wide = dict(cfg, sliding_window=64)
    assert float((hybrid.forward(params, wide, toks, torch.arange(40)) - base).abs().max()) > 1e-4
    moved = dict(cfg, global_attn_idx=[0, 3, 5])
    with pytest.raises(ValueError):
        hybrid.forward(params, moved, toks, torch.arange(4))


def test_ssd_pairwise_sum_matches_the_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 23, 3, 4, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.1
    a = -torch.rand(h, generator=g) * 4
    bm, cm = torch.randn(s, 1, n, generator=g), torch.randn(s, 1, n, generator=g)
    d = torch.rand(h, generator=g)
    state = torch.zeros(h, p, n)
    want = []
    for t in range(s):
        state = state * torch.exp(dt[t] * a)[:, None, None] + \
            dt[t][:, None, None] * x[t][:, :, None] * bm[t, 0][None, None, :]
        want.append(torch.einsum("hpn,n->hp", state, cm[t, 0]) + d[:, None] * x[t])
    assert torch.allclose(hybrid.ssd(x, dt, a, bm, cm, d), torch.stack(want), atol=1e-5)
