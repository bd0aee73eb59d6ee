"""The serving engine's decode batch (``serve/batch.py``) on the CPU: a
slot's own state saved to the host tier and loaded into another slot comes
back bit for bit, its length too, and a prefill into one slot leaves every
other slot's state as it was.  The engine built on the batch is held
against the reference's engine by the parity tests
(``test_torch_engine*.py``)."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.serve.batch import DecodeBatch  # noqa: E402
from repro_torch.serve.engine import EngineStats  # noqa: E402
from test_torch_decode_graph import CTX, arch_model, cache_tensors  # noqa: E402

ARCHS = ["granite-3-8b", "gemma3-4b", "hymba-1.5b", "mamba2-2.7b", "granite-4.0-h-small"]
PAGE, MAX_PAGES = 4, 8


def filled(name):
    """A 3-slot batch with prompts of 13 and 9 tokens prefilled into slots
    0 and 2, on pool slots 0-3 and 4-6; slot 1 empty."""
    cfg, params = arch_model(name)
    b = DecodeBatch(params, cfg, CTX, EngineStats(), max_batch=3, max_pages=MAX_PAGES,
                    pool_slots=12, page=PAGE, device=torch.device("cpu"))
    rng = np.random.default_rng(1)
    for slot, n, first in ((0, 13, 0), (2, 9, 4)):
        row = np.full(MAX_PAGES, -1, np.int32)
        pages = (n + PAGE) // PAGE
        row[:pages] = np.arange(first, first + pages)
        b.prefill(rng.integers(2, cfg.vocab, size=n), slot, row)
    return cfg, b


def per_slot(name):
    """Whether ``cache_tensors``' entry ``name`` has a row per slot."""
    return ".pool." not in name


@pytest.mark.parametrize("name", ARCHS)
def test_saved_slot_state_loads_into_another_slot_bit_for_bit(name):
    _, b = filled(name)
    before = {k: t.clone() for k, t in cache_tensors(b.caches).items()}
    blob = b.save(2)
    assert blob.length == 9
    assert blob.nbytes == sum(t[2].nbytes for k, t in before.items()
                              if per_slot(k) and k != "lengths")
    for k, t in cache_tensors(b.caches).items():
        if per_slot(k):
            t[1].fill_(7)                 # the target slot holds other bytes
    b.load(1, blob)
    after = cache_tensors(b.caches)
    assert after.keys() == before.keys()
    for k, t in after.items():
        if per_slot(k):
            assert torch.equal(t[1], before[k][2]), k
            for s in (0, 2):
                assert torch.equal(t[s], before[k][s]), k
        else:
            assert torch.equal(t, before[k]), k
    assert b.lengths().tolist() == [13, 9, 9]


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_into_a_slot_leaves_the_other_slots(name):
    cfg, b = filled(name)
    before = {k: t.clone() for k, t in cache_tensors(b.caches).items()}
    row = np.full(MAX_PAGES, -1, np.int32)
    row[:3] = [8, 9, 10]
    b.prefill(np.random.default_rng(2).integers(2, cfg.vocab, size=11), 1, row)
    after = cache_tensors(b.caches)
    moved = []
    for k, t in after.items():
        if per_slot(k):
            for s in (0, 2):
                assert torch.equal(t[s], before[k][s]), k
            moved.append(not torch.equal(t[1], before[k][1]))
        else:                             # a pool: only the row's pages
            keep = [s for s in range(t.shape[0]) if s not in (8, 9, 10)]
            assert torch.equal(t[keep], before[k][keep]), k
            moved.append(not torch.equal(t[8:11], before[k][8:11]))
    assert all(moved)
    assert b.lengths().tolist() == [13, 11, 9]
