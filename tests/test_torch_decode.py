"""Decode path of the port: its incremental decode matches its own forward
at every position (the ``test_decode.py`` invariant), its prefill and
decode logits match the JAX reference within 1e-4 (f32), and inactive
batch slots neither append nor advance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import decode as ref_D  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import device_ops as dev  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

NAMES = ["granite-3-8b", "gemma3-4b"]
REF_CTX = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
# the reference path, compiled once per shape (eager JAX is slow on CPU)
ref_prefill = jax.jit(ref_D.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(ref_D.decode_step, static_argnums=(3, 4))
CTX = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in NAMES:
        cfg = reduced(ARCHS[name])
        params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
        tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
        out[name] = (cfg, params, t_reduced(T_ARCHS[name]), tparams)
    return out


def clone_caches(caches):
    return bridge.tree_map(lambda t: t.clone(), caches)


@pytest.mark.parametrize("name", NAMES)
def test_incremental_decode_matches_forward_and_reference(models, name):
    """Prefill 20 tokens (past gemma3's reduced 16-token window, so the ring
    wraps), then decode: every step matches the port's full forward and the
    JAX decode path."""
    cfg, params, tcfg, tparams = models[name]
    B, S_prompt, n_dec, page = 2, 20, 6, 4
    S_total = S_prompt + n_dec
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S_total))
    h, _ = T.forward_hidden(tparams, torch.from_numpy(toks), tcfg, CTX)
    fwd = h @ T.unembed_matrix(tparams, tcfg)

    max_pages = (S_total + page - 1) // page + 1
    bt = np.arange(B * max_pages, dtype=np.int32).reshape(B, max_pages)
    caches = D.init_caches(tcfg, B, pool_slots=B * max_pages + 2, page=page,
                           device="cpu")
    ref_caches = ref_D.init_caches(cfg, B, pool_slots=B * max_pages + 2,
                                   page=page)
    logits, caches = D.prefill(tparams, torch.from_numpy(toks[:, :S_prompt]),
                               tcfg, CTX, caches, torch.from_numpy(bt))
    ref_logits, ref_caches = ref_prefill(params, jnp.asarray(toks[:, :S_prompt]),
                                           cfg, REF_CTX, ref_caches,
                                           jnp.asarray(bt))
    v = cfg.vocab
    np.testing.assert_allclose(logits[:, :v].numpy(),
                               fwd[:, S_prompt - 1, :v].numpy(), atol=5e-2)
    np.testing.assert_allclose(logits[:, :v].numpy(),
                               np.asarray(ref_logits)[:, :v], atol=1e-4,
                               rtol=1e-4)
    for t in range(S_prompt, S_total - 1):
        app_slot, app_off = bt[:, t // page], np.full((B,), t % page, np.int32)
        logits, caches = D.decode_step(
            tparams, caches, torch.from_numpy(toks[:, t]), tcfg, CTX,
            torch.from_numpy(bt), torch.from_numpy(app_slot),
            torch.from_numpy(app_off))
        ref_logits, ref_caches = ref_decode_step(
            params, ref_caches, jnp.asarray(toks[:, t]), cfg, REF_CTX,
            jnp.asarray(bt), jnp.asarray(app_slot), jnp.asarray(app_off))
        np.testing.assert_allclose(logits[:, :v].numpy(),
                                   fwd[:, t, :v].numpy(), atol=5e-2,
                                   err_msg=f"position {t}")
        np.testing.assert_allclose(logits[:, :v].numpy(),
                                   np.asarray(ref_logits)[:, :v], atol=1e-4,
                                   rtol=1e-4, err_msg=f"position {t}")
    for li, (c, rc) in enumerate(zip(caches["layers"], ref_caches["layers"])):
        for key in c:
            np.testing.assert_allclose(c[key].k.numpy(), np.asarray(rc[key].k),
                                       atol=1e-5, err_msg=f"layer {li} {key}")
    np.testing.assert_array_equal(caches["lengths"].numpy(),
                                  np.asarray(ref_caches["lengths"]))


def test_inactive_slots_do_not_corrupt_state(models):
    """Masked decode: a hole in the batch neither appends nor advances."""
    _, _, tcfg, tparams = models["granite-3-8b"]
    B, S, page, max_pages = 2, 8, 4, 4
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tcfg.vocab, size=(B, S + 2)))
    caches = D.init_caches(tcfg, B, pool_slots=B * max_pages, page=page,
                           device="cpu")
    bt = torch.arange(B * max_pages, dtype=torch.int32).reshape(B, max_pages)
    _, caches = D.prefill(tparams, toks[:, :S], tcfg, CTX, caches, bt)
    app_slot = bt[:, S // page]
    app_off = torch.full((B,), S % page, dtype=torch.int32)

    pool_before = clone_caches(caches)["layers"][0]["pool"]
    logits1, caches1 = D.decode_step(tparams, clone_caches(caches), toks[:, S],
                                     tcfg, CTX, bt, app_slot, app_off,
                                     active=torch.tensor([True, False]))
    assert caches1["lengths"].tolist() == [S + 1, S]   # hole did not advance
    pool1 = caches1["layers"][0]["pool"]
    hole = int(app_slot[1])
    assert torch.equal(pool1.k[hole], pool_before.k[hole])  # nor appended

    logits_both, _ = D.decode_step(tparams, clone_caches(caches), toks[:, S],
                                   tcfg, CTX, bt, app_slot, app_off)
    logits2, _ = D.decode_step(tparams, caches1, toks[:, S], tcfg, CTX, bt,
                               app_slot, app_off,
                               active=torch.tensor([False, True]))
    torch.testing.assert_close(logits2[1], logits_both[1], atol=1e-4, rtol=0)


def test_decode_step_updates_pools_in_place(models):
    _, _, tcfg, tparams = models["granite-3-8b"]
    caches = D.init_caches(tcfg, 1, pool_slots=4, page=4, device="cpu")
    pool = caches["layers"][0]["pool"]
    bt = torch.tensor([[2, -1]], dtype=torch.int32)
    _, out = D.decode_step(tparams, caches, torch.tensor([5]), tcfg, CTX, bt,
                           torch.tensor([2]), torch.tensor([0]))
    assert out["layers"][0]["pool"].k is pool.k
    assert pool.k[2, 0].abs().sum() > 0 and not pool.k[0].any()
    assert isinstance(out["layers"][0]["pool"], dev.KVPool)
