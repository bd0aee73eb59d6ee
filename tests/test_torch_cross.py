"""The port's cross-attention kinds against the JAX reference (CPU, f32):
``forward_hidden`` and ``prefill_logits`` of reduced llama-3.2-vision
(``attn`` + gated ``xattn`` layers over patch embeddings) and reduced
whisper (the ``enc`` encoder over frame embeddings, then ``dec`` layers)
within 1e-4, with each cross-attention gate ``xgate`` set non-zero in the
reference tree before bridging (the reference initialises it to 0, which
shuts the cross path); the frontend moves the logits; the sinusoidal
positions match."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_parity import frontend_for, open_xgates  # noqa: E402

NAMES = ["llama-3.2-vision-11b", "whisper-large-v3"]
REF_CTX = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
CTX = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
B, S = 2, 12


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in NAMES:
        cfg = reduced(ARCHS[name])
        params = open_xgates(ref_T.init_params(jax.random.PRNGKey(0), cfg))
        tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
        out[name] = (cfg, params, t_reduced(T_ARCHS[name]), tparams, toks,
                     frontend_for(cfg, B))
    return out


def close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_forward_hidden_matches_reference(models, name):
    cfg, params, tcfg, tparams, toks, fe = models[name]
    h, aux = ref_T.forward_hidden(params, jnp.asarray(toks), cfg, REF_CTX,
                                  frontend=jnp.asarray(fe))
    th, taux = T.forward_hidden(tparams, torch.from_numpy(toks), tcfg, CTX,
                                frontend=torch.from_numpy(fe))
    assert th.shape == (B, S, cfg.d_model)
    close(th.numpy(), h)
    close(float(taux), float(aux))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_matches_reference(models, name):
    cfg, params, tcfg, tparams, toks, fe = models[name]
    logits = ref_T.prefill_logits(params, jnp.asarray(toks), cfg, REF_CTX,
                                  frontend=jnp.asarray(fe))
    tlogits = T.prefill_logits(tparams, torch.from_numpy(toks), tcfg, CTX,
                               frontend=torch.from_numpy(fe))
    assert tlogits.dtype == torch.float32
    assert tlogits.shape == (B, cfg.padded_vocab)
    close(tlogits[:, :cfg.vocab].numpy(), np.asarray(logits)[:, :cfg.vocab])


@pytest.mark.parametrize("name", NAMES)
def test_the_frontend_moves_the_logits(models, name):
    """The cross path counts: other frontend states give other logits."""
    _, _, tcfg, tparams, toks, fe = models[name]
    a = T.prefill_logits(tparams, torch.from_numpy(toks), tcfg, CTX,
                         frontend=torch.from_numpy(fe))
    b = T.prefill_logits(tparams, torch.from_numpy(toks), tcfg, CTX,
                         frontend=torch.from_numpy(frontend_for(tcfg, B, 1)))
    v = tcfg.vocab
    assert float((a[:, :v] - b[:, :v]).abs().max()) > 1e-3


def test_closed_gate_shuts_the_vision_cross_path(models):
    """With the reference's zero ``xgate`` the frontend changes nothing."""
    _, _, tcfg, tparams, toks, fe = models["llama-3.2-vision-11b"]
    shut = {**tparams, "segments": [
        dict(seg, xgate=torch.zeros_like(seg["xgate"])) if "xgate" in seg
        else seg for seg in tparams["segments"]]}
    a, b = (T.prefill_logits(shut, torch.from_numpy(toks), tcfg, CTX,
                             frontend=torch.from_numpy(f))
            for f in (fe, frontend_for(tcfg, B, 1)))
    assert torch.equal(a, b)


def test_audio_needs_its_frames(models):
    _, _, tcfg, tparams, toks, _ = models["whisper-large-v3"]
    with pytest.raises(ValueError, match="frame embeddings"):
        T.forward_hidden(tparams, torch.from_numpy(toks), tcfg, CTX)


@pytest.mark.parametrize("s,d", [(12, 64), (1536, 1280)])
def test_sinusoidal_positions_match(s, d):
    """Up to whisper's 1536 frames: an f32 angle near 1535 rad is exact to
    about 1e-4, so both packages' sines agree to that."""
    close(T._sinusoidal(s, d).numpy(), ref_T._sinusoidal(s, d))
    assert T.encoder_segments(t_reduced(T_ARCHS["whisper-large-v3"])) == \
        [T.Segment("enc", 2, ffn="gelu")]
