"""The serving engine's decode step replayed as one CUDA graph against the
same step run eagerly, on the card only (without one these skip): the
tokens, pools, rings, SSM states and ``lengths`` come out equal bit for
bit, over steps with holes in the active mask and pauses and resumes
between them; and the two operations that let the step be captured (the
``kv_append`` kernel, the dropless MoE's ``searchsorted`` offsets) equal
the eager operations they replace.

This file imports neither ``jax`` nor the reference package, so it also runs
on a machine with the card and no JAX, from the repository root:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_graph.py
"""
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
from repro_torch.core import device_ops as dev  # noqa: E402
from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.kernels import kv_append as kva  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graph and kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class EagerEngine(ValetServeEngine):
    """The engine with its decode batch's step run eagerly on the card too."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        b = self.batch
        b.issue = lambda n: b._eager(b._counts)


def granite4h_config():
    """granite-4.0-h-small cut as its CPU test cuts it, with widths the
    card's kernels take (the grouped GEMM's K and N multiples of 64)."""
    from test_torch_granite_moe_hybrid import small_config
    c = small_config()
    c.update(hidden_size=128, head_dim=64, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=64, shared_intermediate_size=64, mamba_head_dim=32,
             mamba_d_state=16)
    c["port"].update(d_model=128, head_dim=64, n_heads=2, n_kv_heads=1, d_ff=64)
    c["port"]["ssm"].update(head_dim=32, d_state=16)
    c["port"]["moe"].update(d_expert=64)
    return c


def tiny(name, cuda):
    """A reduced arch, its bf16 weights on the card and a bf16 context."""
    ctx = T.ParallelCtx(remat=False, compute_dtype=torch.bfloat16)
    if name == "granite-4.0-h-small":
        from valetbench.harness.drive import check_layout, port_arch
        from valetbench.harness.weights import make_params
        c = granite4h_config()
        arch = port_arch(c)
        check_layout(c, arch)
        return arch, make_params(c, 7, cuda), ctx
    cfg = reduced(ARCHS[name])
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, bridge.tree_map(lambda t: t.to(cuda, torch.bfloat16), params), ctx


def serve(cls, name, cuda):
    """Eight prompts of mixed lengths and outputs through a 4-row batch and
    a pool that cannot hold them: requests finish at different steps, so
    rows go inactive, and sequences pause and resume."""
    cfg, params, ctx = tiny(name, cuda)
    eng = cls(params, cfg, ctx, max_batch=4, max_seq=64, page=16, pool_slots=7,
              policy=POLICIES["valet"], device=cuda)
    rng = np.random.default_rng(0)
    for n, new in zip((20, 9, 33, 17, 5, 40, 12, 26), (9, 4, 12, 6, 10, 3, 8, 11)):
        eng.submit(rng.integers(2, cfg.vocab, size=n), max_new=new)
    holes = 0
    while eng.step():
        holes += not eng.batch.inputs[4].all()
    torch.cuda.synchronize()
    assert all(r.status == "done" for r in eng._requests.values())
    return eng, holes


def state(eng):
    out = [eng.batch.caches["lengths"]]
    for c in eng.batch.caches["layers"]:
        for key in ("pool", "ring"):
            if key in c:
                out += [c[key].k, c[key].v]
        if "ssm" in c:
            out += [c["ssm"]["h"], c["ssm"]["conv"]]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-8b", "hymba-1.5b", "granite-4.0-h-small",
                                  "gemma3-4b", "mamba2-2.7b", "deepseek-moe-16b"])
def test_cuda_graph_replay_equals_the_eager_step(cuda, name):
    graph, holes = serve(ValetServeEngine, name, cuda)
    eager, _ = serve(EagerEngine, name, cuda)
    st = graph.stats
    assert st.steps >= 8 and holes >= 1 and st.pauses >= 1 and st.restored_pages >= 1
    assert st.graph_replays == st.steps - 1 and eager.stats.graph_replays == 0
    assert [r.tokens_out for r in graph._requests.values()] == \
        [r.tokens_out for r in eager._requests.values()]
    for a, b in zip(state(graph), state(eager)):
        assert torch.equal(a, b)
    assert (st.moe_entries, st.moe_groups) == (eager.stats.moe_entries,
                                               eager.stats.moe_groups)
    if name == "granite-4.0-h-small":
        assert st.moe_entries > 0


@pytest.mark.cuda
@pytest.mark.parametrize("src,pool", [(torch.bfloat16, torch.float32),
                                      (torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16)])
def test_cuda_kv_append_kernel_equals_live_rows_append(cuda, src, pool):
    g = torch.Generator(device=cuda).manual_seed(0)
    n_slots, page, n_kv, hd, b = 40, 16, 8, 128, 64
    before = dev.KVPool(*(torch.randn((n_slots, page, n_kv, hd), device=cuda,
                                      generator=g).to(pool) for _ in range(2)))
    k, v = (torch.randn((b, n_kv, hd), device=cuda, generator=g).to(src) for _ in range(2))
    mask = torch.rand(b, device=cuda, generator=g) > 0.3
    mask[0] = True
    row = torch.arange(b, device=cuda)
    # the owned rows at distinct places; the others aim at row 0's place,
    # past the pool or below it; row 3 owned and past the pool
    aims = torch.tensor([0, n_slots, n_slots + 5, -1], device=cuda)[row % 4]
    slot = torch.where(mask, row // page, aims)
    off = torch.where(mask, row % page, 0)
    mask[3], slot[3] = True, n_slots + 1
    want = dev.KVPool(before.k.clone(), before.v.clone())
    dev.append_token_masked(want, k, v, slot, off, mask,
                            rows=dev.live_rows(mask, slot, n_slots))
    got = dev.KVPool(before.k.clone(), before.v.clone())
    launches = kva.kv_append.launches
    dev.append_token_masked(got, k, v, slot, off, mask)
    assert kva.kv_append.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)


@pytest.mark.cuda
def test_cuda_group_offsets_equal_bincount(cuda):
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(n_experts=72, top_k=10, d_expert=64, dropless=True, held_first=0,
                    held_count=18)
    g = torch.Generator(device=cuda).manual_seed(1)
    eids = torch.argsort(torch.rand((128, 72), device=cuda, generator=g), 1)[:, :10]
    active = torch.rand(128, device=cuda, generator=g) > 0.2
    key, _, counts, offsets, _, _ = M.groups(eids, moe, active)
    want = torch.bincount(key, minlength=19)[:18]
    assert torch.equal(counts, want)
    assert offsets.tolist() == [0] + torch.cumsum(want, 0).tolist()
