"""granite-4.0-h-small on the port (36 Mamba-2 and 4 NoPE attention layers,
a dropless MoE over one chip's share of the experts in every layer,
Granite's four multipliers) against the benchmark's plain reference
(``valetbench/reference/moe_hybrid.py``), at a small size in f32 on the
CPU, on weights the benchmark's harness makes from a seed.  Also: the
dropless MoE against the exact oracle, the shares of the experts adding up
to the uncut layer, a decode row that keeps its bits whatever the other
rows hold, the pattern's segments, and ``ArchConfig`` read from the
configuration file's dicts."""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the tier-1 run sets PYTHONPATH=src only
    sys.path.insert(0, str(ROOT))

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from valetbench.harness.drive import check_layout, port_arch  # noqa: E402
from valetbench.harness.weights import make_params  # noqa: E402
from valetbench.reference import moe_hybrid  # noqa: E402

CONFIG = ROOT / "valetbench" / "configs" / "granite-4.0-h-small.json"
CTX = T.ParallelCtx(remat=False, q_block=8, kv_block=8)
PATTERN = ["ssm", "attn", "ssm", "ssm", "attn"]


def full_config():
    with open(CONFIG) as f:
        return json.load(f)


def small_config():
    """The configuration file cut to a CPU test's size: width 64, 5 layers
    of both kinds, 12 experts routed top-4 of which this chip holds 3-8,
    the published multipliers."""
    c = copy.deepcopy(full_config())
    d, hd = 64, 16
    c.update(hidden_size=d, num_attention_heads=4, num_key_value_heads=2, head_dim=hd,
             intermediate_size=32, shared_intermediate_size=64, vocab_size=300,
             num_hidden_layers=len(PATTERN), mamba_d_state=8, mamba_head_dim=16,
             mamba_chunk_size=8, num_local_experts=6, held_experts_first=3,
             router_experts=12, num_experts_per_tok=4,
             layer_types=["attention" if k == "attn" else "mamba" for k in PATTERN])
    c["layers"] = []
    for k in PATTERN:                  # the runs of like layers
        if c["layers"] and c["layers"][-1]["kind"] == k:
            c["layers"][-1]["count"] += 1
        else:
            c["layers"].append({"kind": k, "count": 1, "window": 0})
    p = c["port"]
    p.update(n_layers=len(PATTERN), d_model=d, n_heads=4, n_kv_heads=2, head_dim=hd,
             d_ff=32, vocab=300, layer_pattern=PATTERN)
    p["ssm"].update(d_state=8, head_dim=16, chunk_size=8)
    p["moe"].update(n_experts=12, top_k=4, n_shared=2, d_expert=32, held_first=3,
                    held_count=6)
    return c


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32(v) for v in tree]
    return tree.float()


@pytest.fixture(scope="module")
def model():
    cfg = small_config()
    arch = port_arch(cfg)
    check_layout(cfg, arch)
    params = f32(make_params(cfg, 2 ** 33 + 11, "cpu"))
    return cfg, arch, params


def test_arch_config_reads_the_configuration_file_dicts():
    c = full_config()
    arch = port_arch(c)
    assert isinstance(arch.moe, MoEConfig) and isinstance(arch.ssm, SSMConfig)
    assert arch.moe.dropless and (arch.moe.held_first, arch.moe.held) == (0, 18)
    assert arch.moe.n_experts == c["router_experts"] == 72
    assert arch.layer_pattern == tuple(
        "attn" if t == "attention" else "ssm" for t in c["layer_types"])
    assert hash(arch) == hash(port_arch(c))
    assert (arch.embedding_multiplier, arch.attention_multiplier,
            arch.residual_multiplier, arch.logits_scaling) == (
        c["embedding_multiplier"], c["attention_multiplier"],
        c["residual_multiplier"], c["logits_scaling"])
    with pytest.raises(ValueError):
        port_arch(dict(c, port=dict(c["port"], layer_pattern=["ssm"] * 39)))
    with pytest.raises(ValueError):
        port_arch(dict(c, port=dict(c["port"], layer_pattern=["mlp"] * 40)))


def test_segments_are_the_runs_of_the_pattern():
    c = full_config()
    arch = port_arch(c)
    check_layout(c, arch)              # the runs the weights are laid out by
    segs = T.segments(arch)
    assert [(s.kind, s.count) for s in segs] == [
        ("ssm", 5), ("attn", 1), ("ssm", 9), ("attn", 1), ("ssm", 9), ("attn", 1),
        ("ssm", 9), ("attn", 1), ("ssm", 4)]
    assert all(s.ffn == "moe" and s.window == 0 for s in segs)
    infos = D.layer_infos(arch)
    assert [i for i, inf in enumerate(infos) if inf.uses_paged] == [5, 15, 25, 35]
    assert sum(inf.uses_ssm for inf in infos) == 36


def test_absent_multipliers_issue_nothing():
    arch = port_arch(full_config())
    plain = ArchConfig(name="x", family="dense", n_layers=1, d_model=8, n_heads=2,
                       n_kv_heads=1, d_ff=8, vocab=16)
    x = torch.randn(3, 8)
    for fn in (T.scale_embed, T.scale_q, T.scale_residual, T.scale_logits):
        assert fn(x, plain) is x
        assert fn(x, arch) is not x


def test_harness_lays_out_the_port_tree(model):
    cfg, arch, params = model
    mine = T.init_params(arch, generator=torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: shapes(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v, path + (i,)) for i, v in enumerate(tree)]
        return tuple(tree.shape)
    assert shapes(params) == shapes(mine)
    assert mine["segments"][0]["moe"]["experts"]["wg"].shape[1] == 6   # held, unpadded


def prefill_and_decode(params, arch, prompt, n_new):
    """The port's prefill logits, then each decode step's, through paged
    caches as the engine lays them out; the tokens are the greedy ones."""
    page, slots = 4, 16
    caches = D.init_caches(arch, 1, pool_slots=slots, page=page, device="cpu")
    table = torch.arange(slots, dtype=torch.long)[None]
    logits, caches = D.prefill(params, torch.as_tensor(prompt)[None], arch, CTX, caches,
                               table[:, : -(-len(prompt) // page) + 1])
    out, toks = [logits[0]], [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        pos = int(caches["lengths"][0])
        logits, caches = D.decode_step(
            params, caches, torch.tensor([toks[-1]]), arch, CTX, table,
            torch.tensor([pos // page]), torch.tensor([pos % page]))
        out.append(logits[0])
        toks.append(int(logits[0].argmax()))
    return torch.stack(out), toks


def test_prefill_and_decode_match_the_reference(model):
    cfg, arch, params = model
    prompt = np.random.default_rng(5).integers(2, cfg["vocab_size"], size=21)
    with torch.no_grad():
        port, toks = prefill_and_decode(params, arch, prompt, 9)
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))
        rows = torch.arange(len(prompt) - 1, len(seq))
        ref = moe_hybrid.forward(params, cfg, seq, rows)
    port = port[:, : cfg["vocab_size"]]
    scale = float(ref.abs().max())
    # both f32 over the same weights: chunked SSD scan and recurrent decode
    # against the pairwise sum, blockwise and paged attention against the
    # plain softmax, sums in other orders: ~1e-6 relative; a dropped entry,
    # a missing multiplier or a wrong expert moves logits by 1e-2 and more
    assert float((port - ref).abs().max()) < 1e-4 * scale
    assert scale > 0.01


def test_the_engine_serves_the_reference_greedy_tokens(model):
    cfg, arch, params = model
    eng = ValetServeEngine(params, arch, CTX, max_batch=3, max_seq=40, page=4,
                           pool_slots=40, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg["vocab_size"], size=n) for n in (9, 14, 11, 17)]
    for p in prompts:
        eng.submit(p, max_new=7)
    reqs = eng.run()
    assert eng.stats.pauses == 0 and all(r.status == "done" for r in reqs)
    with torch.no_grad():
        for r, p in zip(reqs, prompts):
            seq = torch.as_tensor(np.concatenate([p, r.tokens_out[:-1]]))
            ref = moe_hybrid.forward(params, cfg, seq, torch.arange(len(p) - 1, len(seq)))
            got = ref.gather(1, torch.as_tensor(r.tokens_out)[:, None])[:, 0]
            # a served token's logit below the reference's best: f32
            # rounding only (~1e-6); a wrong step reads ~0.1 and more
            assert float((ref.max(-1).values - got).max()) < 1e-4
    # every held entry was counted on the device and read back
    assert eng.stats.moe_entries > 0 and eng.stats.moe_groups > 0
    n_calls = arch.n_layers * (len(prompts) + eng.stats.steps)
    assert eng.stats.moe_groups <= n_calls * arch.moe.held


def moe_params(moe, d, seed):
    g = torch.Generator().manual_seed(seed)
    p = M.init_moe(d, moe, 1, generator=g, device="cpu")
    p["router"] *= 50                  # decisive routing: no near-ties
    return {k: ({n: w[0] for n, w in v.items()} if isinstance(v, dict) else v[0])
            for k, v in p.items()}


MOE = MoEConfig(n_experts=12, top_k=4, n_shared=2, d_expert=16, renorm_topk=True,
                dropless=True)


def test_dropless_matches_the_exact_oracle_and_drops_nothing():
    d = 32
    p = moe_params(MOE, d, 1)
    x = torch.randn(37, d, generator=torch.Generator().manual_seed(2))
    got = []
    with M.tally(got):
        out, aux = M.moe_ffn_dropless(p, x, MOE)
    want, want_aux = M.moe_ffn_reference(p, x, MOE)
    # both f32; the oracle sums every expert's masked output, this path
    # only the chosen ones: ~1e-7 relative
    assert torch.allclose(out, want, atol=1e-5, rtol=1e-5)
    assert torch.allclose(torch.as_tensor(aux), torch.as_tensor(want_aux), atol=1e-7)
    # every one of the T k entries was computed, and by its expert
    eids = M.router_topk(p, x, MOE)[0]
    assert int(got[0].sum()) == x.shape[0] * MOE.top_k
    assert torch.equal(got[0], torch.bincount(eids.reshape(-1), minlength=12))
    # the capacity path at the same routing drops (cap 8 < the busiest
    # expert's entries), which the dropless path does not
    low = MoEConfig(**{**MOE.__dict__, "dropless": False, "capacity_factor": 0.5})
    pad = M.padded_experts(low) - MOE.n_experts          # its table is padded
    padded = dict(p, experts={k: torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad))
                              for k, w in p["experts"].items()})
    assert not torch.allclose(M.moe_ffn(padded, x, low)[0], want, atol=1e-3)


def test_the_shares_add_up_to_the_uncut_layer():
    d, shares = 32, 4
    p = moe_params(MOE, d, 3)
    x = torch.randn(29, d, generator=torch.Generator().manual_seed(4))
    whole = M.moe_ffn_dropless(p, x, MOE, with_aux=False)
    shared = M.swiglu(p["shared"], x)
    held = MOE.n_experts // shares
    total = shared.clone()
    for s in range(shares):
        share = MoEConfig(**{**MOE.__dict__, "held_first": s * held, "held_count": held})
        ps = dict(p, experts={k: w[s * held:(s + 1) * held]
                              for k, w in p["experts"].items()})
        total += M.moe_ffn_dropless(ps, x, share, with_aux=False) - shared
    # f32 sums of the same terms in another grouping: ~1e-7 relative
    assert torch.allclose(total, whole, atol=1e-5, rtol=1e-5)


def test_a_decode_row_keeps_its_bits_whatever_the_other_rows_hold(model):
    cfg, arch, params = model
    b, page, slots = 4, 4, 32
    rng = np.random.default_rng(7)
    prompt = rng.integers(2, cfg["vocab_size"], size=10)

    def row0(tokens, active):
        caches = D.init_caches(arch, b, pool_slots=slots, page=page, device="cpu")
        one = D.init_caches(arch, 1, pool_slots=slots, page=page, device="cpu")
        for c, o in zip(caches["layers"], one["layers"]):
            if "pool" in c:
                o["pool"] = c["pool"]
        table = torch.arange(slots, dtype=torch.long).view(b, -1)
        _, one = D.prefill(params, torch.as_tensor(prompt)[None], arch, CTX, one, table[:1])
        for c, o in zip(caches["layers"], one["layers"]):
            if "ssm" in c:
                c["ssm"]["h"][0].copy_(o["ssm"]["h"][0])
                c["ssm"]["conv"][0].copy_(o["ssm"]["conv"][0])
        caches["lengths"][0] = len(prompt)
        pos = torch.tensor([len(prompt), 0, 0, 0])
        logits, _ = D.decode_step(params, caches, torch.as_tensor(tokens), arch, CTX,
                                  table, pos // page + torch.arange(b) * (slots // b),
                                  pos % page, active=torch.as_tensor(active))
        return logits[0]

    with torch.no_grad():
        base = row0([5, 7, 9, 11], [True, True, True, True])
        for tokens, active in (([5, 7, 9, 11], [True, False, False, False]),
                               ([5, 200, 3, 64], [True, True, False, True]),
                               ([5, 200, 3, 64], [True, False, True, True])):
            assert torch.equal(row0(tokens, active), base)


def test_spans_and_marks_of_the_dropless_calls(model):
    cfg, arch, params = model
    eng = ValetServeEngine(params, arch, CTX, max_batch=2, max_seq=32, page=4,
                           pool_slots=20, device="cpu")
    for n in (9, 12):
        eng.submit(np.random.default_rng(n).integers(2, cfg["vocab_size"], size=n),
                   max_new=4)
    spans.take()
    spans.enable()
    try:
        eng.run()
    finally:
        spans.disable()
    recs = spans.take()
    layers = [r for r in recs if r.name == "moe.layer"]
    parents = {recs[r.parent].name for r in layers}
    assert parents == {"engine.decode.issue", "engine.prefill.issue"}
    assert len(layers) == arch.n_layers * (2 + eng.stats.steps)
    entries = [r.n for r in recs if r.name == "moe.entries"]
    groups = [r.n for r in recs if r.name == "moe.groups"]
    assert len(entries) == len(groups) == len(layers)
    assert (sum(entries), sum(groups)) == (eng.stats.moe_entries, eng.stats.moe_groups)
    assert all(r.t0 == r.t1 for r in recs if r.name in ("moe.entries", "moe.groups"))
