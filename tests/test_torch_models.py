"""Model math of the port against the JAX reference (f32, CPU): layers,
both attention functions, the decode partials, and ``forward_hidden``
logits for the reduced dense and sliding-window archs.  ``init_params`` is
checked in ``test_torch_configs.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DENSE = ["granite-3-8b", "gemma3-4b", "phi3-mini-3.8b", "h2o-danube-3-4b"]


def rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def close(want, got, tol=1e-5):
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(),
                               atol=tol, rtol=tol)


def test_rms_norm_and_rope_match():
    x, w = rand(0, (2, 5, 3, 16)), rand(1, (16,), 0.1)
    close(ref_layers.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6),
          layers.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-6))
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    for theta in (10_000.0, 1_000_000.0):
        close(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
              layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta))


def test_swiglu_and_gelu_match():
    x = rand(2, (3, 4, 32))
    p = {"wgu": rand(3, (32, 128), 0.1), "wd": rand(4, (64, 32), 0.1)}
    close(ref_layers.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
          layers.swiglu(bridge.to_torch(p, "cpu"), torch.from_numpy(x)))
    g = {"wi": rand(5, (32, 64), 0.1), "wo": rand(6, (64, 32), 0.1)}
    close(ref_layers.gelu_mlp(jax.tree.map(jnp.asarray, g), jnp.asarray(x)),
          layers.gelu_mlp(bridge.to_torch(g, "cpu"), torch.from_numpy(x)))


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 0, 96, 96), (True, 24, 96, 96), (False, 0, 96, 96),
    (False, 0, 64, 77)])                             # ragged cross-attention
def test_attention_matches(causal, window, sq, sk):
    q, k, v = rand(7, (2, sq, 4, 16)), rand(8, (2, sk, 2, 16)), \
        rand(9, (2, sk, 2, 16))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    close(ref_attn.reference_attention(jq, jk, jv, causal=causal,
                                       window=window),
          attn.reference_attention(tq, tk, tv, causal=causal, window=window))
    close(ref_attn.blockwise_attention(jq, jk, jv, causal=causal,
                                       window=window, q_block=32,
                                       kv_block=32),
          attn.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                   q_block=32, kv_block=32))


def test_decode_partial_and_combine_match():
    q, k, v = rand(10, (3, 8, 16)), rand(11, (3, 20, 2, 16)), \
        rand(12, (3, 20, 2, 16))
    valid = np.random.default_rng(13).random((3, 20)) < 0.7
    valid[2] = False                                 # an all-masked row
    rp = ref_attn.decode_partial(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(valid))
    tp = attn.decode_partial(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(valid))
    for a, b in zip(rp, tp):
        close(a, b)
    stacked_r = tuple(jnp.stack([x, x * 0.5]) for x in rp)
    stacked_t = tuple(torch.stack([x, x * 0.5]) for x in tp)
    close(ref_attn.combine_partials(stacked_r, jnp.float32),
          attn.combine_partials(stacked_t, torch.float32))


@pytest.fixture(scope="module")
def ref_models():
    out = {}
    for name in DENSE:
        cfg = reduced(ARCHS[name])
        params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
        out[name] = (cfg, params)
    return out


@pytest.mark.parametrize("name", DENSE)
def test_forward_hidden_logits_match(ref_models, name):
    cfg, params = ref_models[name]
    tcfg = t_reduced(T_ARCHS[name])
    ctx = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
    tctx = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 21))
    h, _ = ref_T.forward_hidden(params, jnp.asarray(toks), cfg, ctx)
    want = ref_T.mask_vocab_pad(
        jnp.einsum("bsd,dv->bsv", h, ref_T.unembed_matrix(params, cfg)), cfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    th, _ = T.forward_hidden(tparams, torch.from_numpy(toks), tcfg, tctx)
    got = T.mask_vocab_pad(th @ T.unembed_matrix(tparams, tcfg), tcfg)
    close(want[..., :cfg.vocab], got[..., :cfg.vocab], tol=1e-4)
