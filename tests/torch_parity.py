"""Shared helpers of the parity tests: drive the JAX reference engine and
the port's engine on the same prompts and compare what they report
(``test_torch_engine*.py``), and the cross-attention archs' frontends and
open gates (``test_torch_decode.py``, ``test_torch_cross.py``)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS, reduced
from repro.core.policies import POLICIES as REF_POLICIES
from repro.models import transformer as ref_T
from repro.serve import ValetServeEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.policies import POLICIES
from repro_torch.models import transformer as T
from repro_torch.serve import ValetServeEngine

REF_CTX = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
CTX = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
GEOM = dict(max_batch=3, max_seq=64, page=4)


def make_setup(name, prompt_lens):
    """Reference params for ``reduced(name)``, the same params in the port,
    and numpy-seeded prompts of the given lengths."""
    cfg = reduced(ARCHS[name])
    params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)) for n in prompt_lens]
    return cfg, params, t_reduced(T_ARCHS[name]), tparams, prompts


def run(engine_cls, params, cfg, ctx, prompts, policies, policy, slots, **kw):
    extra = {"device": "cpu"} if engine_cls is ValetServeEngine else {}
    eng = engine_cls(params, cfg, ctx, pool_slots=slots,
                     policy=policies[policy], **GEOM, **kw, **extra)
    for p in prompts:
        eng.submit(p, max_new=10)
    reqs = eng.run(max_steps=500)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens_out for r in sorted(reqs, key=lambda r: r.rid)], eng


def both(setup, policy, slots, **kw):
    """((ref tokens, ref engine), (port tokens, port engine))."""
    cfg, params, tcfg, tparams, prompts = setup
    ref = run(RefEngine, params, cfg, REF_CTX, prompts, REF_POLICIES, policy,
              slots, **kw)
    port = run(ValetServeEngine, tparams, tcfg, CTX, prompts, POLICIES,
               policy, slots, **kw)
    return ref, port


def assert_same_stats(a, b):
    """``EngineStats`` equal field by field; ``wall_time_s`` excepted and
    the latency reservoirs compared by their samples."""
    for f in dataclasses.fields(a):
        if f.name == "wall_time_s":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("lat", "fence_lat"):
            np.testing.assert_array_equal(x._buf[:x._n], y._buf[:y._n])
            assert x._seen == y._seen
        else:
            assert x == y, f.name


def assert_same_engines(ref_eng, eng):
    assert_same_stats(ref_eng.stats, eng.stats)
    assert len(ref_eng.host) == len(eng.host)
    assert len(ref_eng.device) == len(eng.device)
    assert torch.equal(torch.from_numpy(np.array(ref_eng.caches["lengths"])),
                       eng.batch.caches["lengths"].cpu())


def open_xgates(params, value=0.5):
    """The reference initialises each cross-attention gate ``xgate`` to 0,
    which shuts llama-vision's cross path; set it non-zero so that the
    parity holds that path too."""
    segs = [dict(seg, xgate=jnp.full_like(seg["xgate"], value))
            if "xgate" in seg else seg for seg in params["segments"]]
    return {**params, "segments": segs}


def frontend_for(cfg, b, seed=0):
    """numpy-seeded (B, N, d) frontend states, or None for an arch that
    reads none."""
    if not cfg.n_frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
