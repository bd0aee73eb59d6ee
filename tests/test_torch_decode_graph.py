"""What lets the serving engine replay a decode step as one CUDA graph, on
the CPU: the sync-free masked append (``kernels/kv_append.py``'s plain
version) writes what ``append_token_masked`` with ``live_rows`` writes;
the dropless MoE's group offsets from ``searchsorted`` are the ``bincount``
ones; ``decode_step`` writes every cache in place, each SSM layer's new
state and ``lengths`` included, for every arch; and the CPU engine keeps
its eager step (no replay)."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the tier-1 run sets PYTHONPATH=src only
    sys.path.insert(0, str(ROOT))

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import device_ops as dev  # noqa: E402
from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.kernels.kv_append import kv_append, kv_append_plain  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from test_torch_granite_moe_hybrid import small_config  # noqa: E402
from valetbench.harness.drive import port_arch  # noqa: E402
from valetbench.harness.weights import make_params  # noqa: E402

CTX = T.ParallelCtx(remat=False, q_block=8, kv_block=8)
N_SLOTS, PAGE, N_KV, HD = 6, 4, 2, 8

# (mask, slot, off): inactive rows with a slot out of range, negative, 0
# (where an active row appends, at its offset too), and an active row out
# of range
APPENDS = {
    "holes": ([1, 0, 1, 0, 1, 0], [2, 9, 0, 0, 5, -1], [1, 3, 3, 3, 0, 2]),
    "active-out-of-range": ([1, 1, 1, 0, 0, 1], [0, 6, 3, 0, 1, 7], [0, 1, 2, 0, 3, 3]),
    "none": ([0, 0, 0, 0, 0, 0], [0, 1, 2, 3, 4, 5], [0, 0, 0, 0, 0, 0]),
    "all": ([1, 1, 1, 1, 1, 1], [0, 1, 2, 3, 4, 5], [3, 2, 1, 0, 3, 2]),
}


@pytest.mark.parametrize("src,pool", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("case", list(APPENDS))
def test_sync_free_append_equals_live_rows_append(case, src, pool):
    mask, slot, off = (torch.tensor(a) for a in APPENDS[case])
    mask = mask.bool()
    g = torch.Generator().manual_seed(3)
    before = dev.KVPool(*(torch.randn((N_SLOTS, PAGE, N_KV, HD), generator=g).to(pool)
                          for _ in range(2)))
    k, v = (torch.randn((6, N_KV, HD), generator=g).to(src) for _ in range(2))
    want = dev.KVPool(before.k.clone(), before.v.clone())
    dev.append_token_masked(want, k, v, slot, off, mask,
                            rows=dev.live_rows(mask, slot, N_SLOTS))
    got = dev.KVPool(before.k.clone(), before.v.clone())
    kv_append(got.k, got.v, k, v, slot, off, mask)
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
    # the rows that write are exactly the owned in-range ones
    live = mask & (slot >= 0) & (slot < N_SLOTS)
    assert int((got.k != before.k).flatten(2).any(-1).sum()) == int(live.sum())


def test_plain_append_checks_its_inputs():
    pool = torch.zeros((N_SLOTS, PAGE, N_KV, HD))
    k = torch.zeros((2, N_KV, HD))
    idx = torch.zeros(2, dtype=torch.long)
    with pytest.raises(TypeError):
        kv_append(pool, pool, k, k, idx, idx, idx)
    with pytest.raises(ValueError):
        kv_append(pool, pool, k[:, :1], k[:, :1], idx, idx, idx.bool())
    kv_append_plain(pool, pool.clone(), k + 1, k + 1, idx, idx, idx.bool())
    assert not pool.any()


MOES = {
    "held-middle": MoEConfig(n_experts=16, top_k=4, d_expert=8, dropless=True,
                             held_first=4, held_count=8),
    "held-all": MoEConfig(n_experts=8, top_k=2, d_expert=8, dropless=True),
    "held-one": MoEConfig(n_experts=12, top_k=3, d_expert=8, dropless=True,
                          held_first=11, held_count=1),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("name", list(MOES))
def test_group_offsets_equal_bincount(name, with_active, seed):
    moe = MOES[name]
    g = torch.Generator().manual_seed(seed)
    t = 37
    # each row's top_k distinct experts
    eids = torch.argsort(torch.rand((t, moe.n_experts), generator=g), 1)[:, :moe.top_k]
    active = torch.rand(t, generator=g) > 0.3 if with_active else None
    key, order, counts, offsets, n_max, _ = M.groups(eids, moe, active)
    want = torch.bincount(key, minlength=moe.held + 1)[:moe.held]
    assert counts.dtype == torch.int64 and torch.equal(counts, want)
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0] + np.cumsum(want.numpy()).tolist()
    assert int(offsets[-1]) <= n_max


def arch_model(name):
    """A reduced arch and f32 weights from a seed: the ten archs of
    ``configs.ARCHS`` and granite-4.0-h-small cut as its CPU test cuts it."""
    if name == "granite-4.0-h-small":
        c = small_config()
        return port_arch(c), _f32(make_params(c, 5, "cpu"))
    cfg = reduced(ARCHS[name])
    return cfg, T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def cache_tensors(caches):
    """Every tensor of ``caches``, by a name."""
    out = {"lengths": caches["lengths"]}
    for li, c in enumerate(caches["layers"]):
        for key, val in c.items():
            if key == "ssm":
                out.update({f"{li}.ssm.{f}": val[f] for f in ("h", "conv")})
            elif key in ("pool", "ring"):
                out.update({f"{li}.{key}.k": val.k, f"{li}.{key}.v": val.v})
            else:
                out[f"{li}.{key}"] = val
    return out


@pytest.mark.parametrize("name", sorted(ARCHS) + ["granite-4.0-h-small"])
def test_decode_step_writes_every_cache_in_place(name, monkeypatch):
    """After a step with a hole, the caches are the tensors they were,
    each SSM layer's state holding what ``ssm_decode_step`` returned,
    ``lengths`` advanced on the active rows, and the hole's page unwritten."""
    cfg, params = arch_model(name)
    b, page, max_pages = 3, 4, 3
    caches = D.init_caches(cfg, b, pool_slots=b * max_pages, page=page, device="cpu")
    g = torch.Generator().manual_seed(1)
    for t in cache_tensors(caches).values():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    caches["lengths"].copy_(torch.tensor([5, 2, 7], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache_tensors(caches).items()}
    ids = {k: v for k, v in cache_tensors(caches).items()}
    bt = torch.arange(b * max_pages, dtype=torch.int32).reshape(b, max_pages)
    lengths = caches["lengths"].long()
    app_slot, app_off = bt[torch.arange(b), lengths // page], lengths % page
    active = torch.tensor([True, False, True])
    returned = []
    real = D.ssm_lib.ssm_decode_step

    def recording(*a, **k):
        y, new = real(*a, **k)
        returned.append({f: t.clone() for f, t in new.items()})
        return y, new
    monkeypatch.setattr(D.ssm_lib, "ssm_decode_step", recording)
    with torch.no_grad():
        _, out = D.decode_step(params, caches, torch.tensor([3, 4, 5]), cfg, CTX, bt,
                               app_slot, app_off, active=active)
    assert out is caches
    after = cache_tensors(caches)
    assert after.keys() == ids.keys()
    assert all(after[k] is ids[k] for k in ids)
    assert caches["lengths"].tolist() == [6, 2, 8]
    ssm_layers = [li for li, c in enumerate(caches["layers"]) if "ssm" in c]
    assert bool(ssm_layers) == (cfg.ssm is not None)
    assert len(returned) == len(ssm_layers)
    for li, new in zip(ssm_layers, returned):
        for f in ("h", "conv"):
            assert torch.equal(after[f"{li}.ssm.{f}"], new[f])
            assert not torch.equal(after[f"{li}.ssm.{f}"], before[f"{li}.ssm.{f}"])
    hole = int(app_slot[1])
    for key in after:
        if ".pool." in key:
            assert torch.equal(after[key][hole], before[key][hole])
            assert not torch.equal(after[key], before[key])


def test_cpu_engine_steps_eagerly():
    cfg, params = arch_model("hymba-1.5b")
    eng = ValetServeEngine(params, cfg, CTX, max_batch=2, max_seq=32, page=4,
                           pool_slots=12, policy=POLICIES["valet"], device="cpu")
    for n in (5, 9, 7):
        eng.submit(np.arange(2, 2 + n), max_new=4)
    lengths = eng.batch.caches["lengths"]
    reqs = eng.run(max_steps=100)
    assert all(r.status == "done" for r in reqs)
    assert eng.stats.graph_replays == 0 and eng.batch._graph is None
    assert eng.batch.caches["lengths"] is lengths

