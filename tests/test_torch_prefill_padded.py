"""The padded prefill (``models.decode.prefill`` given ``length``) on the
CPU, run eagerly: a prompt padded to its bucket gives the unpadded
prompt's logits, pool pages, rings, SSM state and length, and the dropless
MoE counts the same entries; which archs and lengths the decode batch pads
(the rest take the unpadded prefill); and the decode batch's padded
prefill into a slot, which its CUDA graphs replay on the card, against its
unpadded one."""
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

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.batch import GRANULE, DecodeBatch  # noqa: E402
from repro_torch.serve.engine import EngineStats  # noqa: E402
from test_torch_decode_graph import CTX, arch_model, cache_tensors  # noqa: E402

PAGE = 16
POOL = 48


def hymba(window):
    """A reduced hymba of five layers, the second and fourth in a window
    ring of ``window`` tokens."""
    cfg = dataclasses.replace(reduced(ARCHS["hymba-1.5b"]), n_layers=5, window=window)
    return cfg, T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


MODELS = {
    "dense-gqa": lambda: arch_model("granite-3-8b"),
    "hymba-window-8": lambda: hymba(8),
    "hymba-window-512": lambda: hymba(512),
    "granite-4.0-h-small": lambda: arch_model("granite-4.0-h-small"),
}
# a bucket's edge, one below it, one past the previous edge, under a page
LENGTHS = [GRANULE, GRANULE - 1, GRANULE + 1, 3]


def caches_for(cfg, g):
    """B=1 caches whose pools hold noise (the pages of other sequences)."""
    c = D.init_caches(cfg, 1, pool_slots=POOL, page=PAGE, device="cpu")
    for name, t in cache_tensors(c).items():
        if ".pool." in name:
            t.copy_(torch.randn(t.shape, generator=g))
    return c


def block_row(s, pages, g):
    """The engine's row for a prompt of ``s`` tokens: ``pages_for(s + 1)``
    distinct pool slots, then -1."""
    row = torch.full((1, pages), -1, dtype=torch.int64)
    need = s // PAGE + 1
    row[0, :need] = torch.randperm(POOL, generator=g)[:need]
    return row


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("model", list(MODELS))
def test_padded_prefill_equals_the_unpadded_one(model, s):
    cfg, params = MODELS[model]()
    sb = -(-s // GRANULE) * GRANULE
    g = torch.Generator().manual_seed(s)
    tokens = torch.randint(2, cfg.vocab, (1, s), generator=g)
    bt = block_row(s, sb // PAGE + 1, g)
    want_c = caches_for(cfg, torch.Generator().manual_seed(9))
    got_c = caches_for(cfg, torch.Generator().manual_seed(9))
    for name, t in cache_tensors(got_c).items():
        if ".ring." in name:            # a reused ring: its old bytes go
            t.copy_(torch.randn(t.shape, generator=g))
    # the padding holds other tokens: nothing of it may show
    padded = torch.cat([tokens, torch.randint(2, cfg.vocab, (1, sb - s), generator=g)], 1)
    want_n, got_n = [], []
    with torch.no_grad():
        with M.tally(want_n):
            want, want_out = D.prefill(params, tokens, cfg, CTX, want_c, bt)
        with M.tally(got_n):
            got, got_out = D.prefill(params, padded, cfg, CTX, got_c, bt,
                                     length=torch.tensor([s]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    want_t, got_t = cache_tensors(want_out), cache_tensors(got_out)
    assert got_t.keys() == want_t.keys()
    assert torch.equal(got_t.pop("lengths"), want_t.pop("lengths"))
    assert want_out["lengths"].tolist() == [s]
    for name, t in got_t.items():
        torch.testing.assert_close(t, want_t[name], rtol=1e-5, atol=1e-5, msg=name)
        if ".pool." in name:            # the prompt's pages only, and all of them
            moved = (t != cache_tensors(caches_for(cfg, torch.Generator().manual_seed(9)))
                     [name]).flatten(1).any(1)
            assert set(moved.nonzero().flatten().tolist()) <= set(bt[0, :s // PAGE + 1].tolist())
    assert len(got_n) == len(want_n)
    for a, b in zip(got_n, want_n):
        assert torch.equal(a, b)
    if model == "granite-4.0-h-small":
        assert want_n and sum(int(c.sum()) for c in want_n) > 0


@pytest.mark.parametrize("name", sorted(ARCHS) + ["granite-4.0-h-small"])
def test_capacity_moe_and_frontends_take_the_unpadded_prefill(name):
    cfg, params = arch_model(name)
    eager = name in ("deepseek-moe-16b", "qwen2-moe-a2.7b", "llama-3.2-vision-11b",
                     "whisper-large-v3")
    assert D.pads_exactly(cfg) is not eager
    b = DecodeBatch(params, cfg, CTX, EngineStats(), max_batch=1, max_pages=19,
                    pool_slots=20, page=PAGE, device=torch.device("cpu"))
    # 19 pages of 16 cover 304 tokens: one bucket, of 256
    want = [GRANULE, GRANULE, None, None] if not eager else [None] * 4
    assert [b.bucket(n) for n in (1, GRANULE, GRANULE + 1, 304)] == want
    if eager:
        with pytest.raises(ValueError):
            D.prefill(params, torch.ones((1, 8), dtype=torch.long), cfg, CTX,
                      D.init_caches(cfg, 1, pool_slots=4, page=PAGE, device="cpu"),
                      torch.arange(4)[None], length=torch.tensor([5]))


def batch(cfg, params):
    return DecodeBatch(params, cfg, CTX, EngineStats(), max_batch=3, max_pages=20,
                       pool_slots=POOL, page=PAGE, device=torch.device("cpu"))


def run_padded(b, tokens, slot, row):
    sb = b.bucket(len(tokens))
    b.stage(tokens, slot, row, sb)
    b.padded(sb, b._counts)
    return b._plogits


@pytest.mark.parametrize("model", ["hymba-window-8", "granite-4.0-h-small"])
def test_batch_padded_prefill_into_a_slot_equals_the_unpadded_one(model):
    """The decode batch's padded prefill (what its graphs replay), a long
    prompt then a short one into slot 1 through the same B=1 caches, leaves
    the slot, its length and the pools as the unpadded prefill of the short
    prompt alone does, and every other slot as it was."""
    cfg, params = MODELS[model]()
    rng = np.random.default_rng(4)
    row = lambda first, n: np.r_[np.arange(first, first + n // PAGE + 1),
                                 np.full(20 - n // PAGE - 1, -1)].astype(np.int32)
    short, long_ = rng.integers(2, cfg.vocab, size=37), rng.integers(2, cfg.vocab, size=250)
    with torch.no_grad():
        want = batch(cfg, params)
        want.prefill(long_, 0, row(20, 250))
        want_logits = want.prefill(short, 1, row(0, 37))
        got = batch(cfg, params)
        got.prefill(long_, 0, row(20, 250))
        run_padded(got, long_, 1, row(0, 250))
        got_logits = run_padded(got, short, 1, row(0, 37))
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    w, g = cache_tensors(want.caches), cache_tensors(got.caches)
    assert torch.equal(g.pop("lengths"), w.pop("lengths"))
    assert got.caches["lengths"].tolist() == [250, 37, 0]
    for name, t in g.items():
        if ".pool." in name:            # the short prompt's pages, the long one's
            torch.testing.assert_close(t[:3], w[name][:3], rtol=1e-5, atol=1e-5)
            assert torch.equal(t[20:], w[name][20:]), name
        else:
            torch.testing.assert_close(t[1], w[name][1], rtol=1e-5, atol=1e-5, msg=name)
            assert torch.equal(t[0], w[name][0]) and torch.equal(t[2], w[name][2]), name


def test_unpadded_prefill_reuses_its_caches_exactly():
    """A long prompt then a short one into one slot through the batch's
    reused B=1 caches (the CPU's prefill) leaves what the short prompt
    alone leaves: no ring slot keeps the long prompt."""
    cfg, params = hymba(8)
    rng = np.random.default_rng(5)
    short, long_ = rng.integers(2, cfg.vocab, size=5), rng.integers(2, cfg.vocab, size=30)
    row = np.r_[np.arange(0, 3), np.full(17, -1)].astype(np.int32)
    with torch.no_grad():
        a, b = batch(cfg, params), batch(cfg, params)
        a.prefill(long_, 2, row)
        a.prefill(short, 2, row)
        b.prefill(short, 2, row)
    for name, t in cache_tensors(b.caches).items():
        if ".pool." not in name:
            assert torch.equal(cache_tensors(a.caches)[name], t), name
