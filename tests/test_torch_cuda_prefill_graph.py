"""The decode batch's prefill replayed as its bucket's CUDA graph, on the
card only (without one these skip): a replay equals the same padded
prefill run eagerly, bit for bit (logits, pools, rings, SSM states,
lengths, the MoE's counts); a shorter prompt replayed after a longer one
in the same bucket and slot leaves nothing of the longer one in the slot or
in its pages; and a prompt past the largest bucket takes the unpadded
prefill, with no graph.

This file imports neither ``jax`` nor the reference package, so it also runs
on a machine with the card and no JAX, from the repository root:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_prefill_graph.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.batch import DecodeBatch  # noqa: E402
from repro_torch.serve.engine import EngineStats  # noqa: E402
from test_torch_cuda_graph import cuda, tiny  # noqa: E402,F401

PAGE, MAX_PAGES, POOL = 16, 20, 48
NAMES = ["granite-3-8b", "hymba-windowed", "granite-4.0-h-small", "gemma3-4b",
         "mamba2-2.7b"]


def model(name, cuda):
    """``tiny``'s arch and bf16 weights; "hymba-windowed" a reduced hymba of
    five layers, two of them in a window ring of 8 tokens."""
    if name != "hymba-windowed":
        return tiny(name, cuda)
    cfg = dataclasses.replace(reduced(ARCHS["hymba-1.5b"]), n_layers=5, window=8)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return (cfg, bridge.tree_map(lambda t: t.to(cuda, torch.bfloat16), params),
            T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16))


def batch(cfg, params, ctx, cuda, max_pages=MAX_PAGES):
    return DecodeBatch(params, cfg, ctx, EngineStats(), max_batch=2, max_pages=max_pages,
                       pool_slots=POOL, page=PAGE, device=cuda)


def row(first, n, max_pages=MAX_PAGES):
    """A block-table row: ``n // PAGE + 1`` pages from pool slot ``first``."""
    need = n // PAGE + 1
    return np.r_[np.arange(first, first + need), np.full(max_pages - need, -1)].astype(np.int32)


def eager_padded(b, tokens, slot, bt):
    """The batch's padded prefill run eagerly: what its graph captures."""
    sb = b.bucket(len(tokens))
    b.stage(tokens, slot, bt, sb)
    b.padded(sb, b._counts)
    return b._plogits


def tensors(b):
    out = [b.caches["lengths"]]
    for c in b.caches["layers"]:
        for key in ("pool", "ring"):
            if key in c:
                out += [c[key].k, c[key].v]
        if "ssm" in c:
            out += [c["ssm"]["h"], c["ssm"]["conv"]]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_prefill_replay_equals_the_eager_padded_prefill(cuda, name):
    cfg, params, ctx = model(name, cuda)
    rng = np.random.default_rng(0)
    first, second = rng.integers(2, cfg.vocab, size=200), rng.integers(2, cfg.vocab, size=77)
    graph, eager = batch(cfg, params, ctx, cuda), batch(cfg, params, ctx, cuda)
    with torch.no_grad():
        # the bucket's first prefill runs eagerly and captures; the second replays
        got = [graph.readback(graph.prefill(p, s, row(f, len(p))).argmax(-1))
               for p, s, f in ((first, 0, 0), (second, 1, 20))]
        want = [eager.readback(eager_padded(eager, p, s, row(f, len(p))).argmax(-1))
                for p, s, f in ((first, 0, 0), (second, 1, 20))]
        logits = [graph.prefill(second, 1, row(20, len(second))).clone(),
                  eager_padded(eager, second, 1, row(20, len(second))).clone()]
        graph.readback(logits[0].argmax(-1))
        eager.readback(logits[1].argmax(-1))
    torch.cuda.synchronize()
    assert list(graph._pgraphs) == [256] and not eager._pgraphs
    assert graph.stats.prefill_replays == 2
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert torch.equal(logits[0], logits[1])
    for a, b in zip(tensors(graph), tensors(eager)):
        assert torch.equal(a, b)
    st, es = graph.stats, eager.stats
    assert (st.moe_entries, st.moe_groups) == (es.moe_entries, es.moe_groups)
    if name == "granite-4.0-h-small":
        assert st.moe_entries > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hymba-windowed", "granite-4.0-h-small", "granite-3-8b"])
def test_cuda_shorter_replay_keeps_nothing_of_the_longer(cuda, name):
    cfg, params, ctx = model(name, cuda)
    rng = np.random.default_rng(1)
    long_, short = rng.integers(2, cfg.vocab, size=250), rng.integers(2, cfg.vocab, size=37)
    graph, fresh = batch(cfg, params, ctx, cuda), batch(cfg, params, ctx, cuda)
    with torch.no_grad():
        graph.prefill(long_, 0, row(0, 250))
        got = graph.prefill(short, 0, row(0, 37)).clone()
        want = eager_padded(fresh, short, 0, row(0, 37)).clone()
    torch.cuda.synchronize()
    assert graph.stats.prefill_replays == 1
    assert torch.equal(got, want)
    pages = 37 // PAGE + 1
    for a, b in zip(tensors(graph), tensors(fresh)):
        if a.shape[0] == POOL:                  # a pool: the short prompt's pages
            assert torch.equal(a[:pages], b[:pages])
        else:                                   # lengths, rings, SSM state
            assert torch.equal(a[0], b[0])


@pytest.mark.cuda
def test_cuda_prefill_past_the_largest_bucket_runs_unpadded(cuda):
    """19 pages of 16 cover 304 tokens: a prompt of 280 would pad to 512,
    past the block table, so it takes the unpadded prefill, eagerly."""
    cfg, params, ctx = model("hymba-windowed", cuda)
    prompt = np.random.default_rng(2).integers(2, cfg.vocab, size=280)
    b, plain = batch(cfg, params, ctx, cuda, 19), batch(cfg, params, ctx, cuda, 19)
    assert b.bucket(280) is None and b.bucket(256) == 256
    with torch.no_grad():
        got = b.prefill(prompt, 1, row(0, 280, 19))
        want = plain._unpadded(prompt, 1, row(0, 280, 19))
    torch.cuda.synchronize()
    assert not b._pgraphs and b.stats.prefill_replays == 0
    assert torch.equal(got, want)
    for x, y in zip(tensors(b), tensors(plain)):
        assert torch.equal(x, y)
