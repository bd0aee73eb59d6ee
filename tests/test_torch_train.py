"""Training math of the port against the JAX reference (CPU): ``lm_loss``
and its gradients (labels of -1, a padded vocab, several loss chunks, the
MoE aux), remat on and off bit-identical, one ``make_train_step`` step in
f32, in bf16 compute and with bf16 gradients, ``fit``'s history, the loss
falling, and the SSD scan's ``autograd.Function`` backward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import ARCHS, reduced, replace  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import TrainDataset as RefDataset  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.train import TrainConfig as RefTrainConfig  # noqa: E402
from repro.train import fit as ref_fit  # noqa: E402
from repro.train import make_train_step as ref_make_step  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.configs import replace as t_replace  # noqa: E402
from repro_torch.data import DataConfig, TrainDataset  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import TrainConfig, fit, make_train_step  # noqa: E402

from torch_train_parity import assert_update_close  # noqa: E402

REF_CTX = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8,
                            compute_dtype=jnp.float32)


def ctx(remat=False, dtype=torch.float32, q_block=8):
    return T.ParallelCtx(remat=remat, q_block=q_block, kv_block=8,
                         loss_chunk=8, compute_dtype=dtype)


def setup(name, vocab=None):
    """Reference params of ``reduced(name)`` (vocab overridden to make a
    padded tail), the same params in the port, and both configs."""
    cfg, tcfg = reduced(ARCHS[name]), t_reduced(T_ARCHS[name])
    if vocab is not None:
        cfg, tcfg = replace(cfg, vocab=vocab), t_replace(tcfg, vocab=vocab)
    params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    return cfg, tcfg, params, tparams


def batch(cfg, shape, seed=0):
    """numpy-seeded tokens and labels with a few -1 labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
    labels.reshape(-1)[::7] = -1
    return toks, labels


def leaves_close(want_tree, got_tree, rtol, atol):
    want = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        want_tree))
    got = bridge.tree_flatten(bridge.to_numpy(got_tree))[0]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,vocab", [("granite-3-8b", 200),
                                        ("gemma3-4b", 250),
                                        ("deepseek-moe-16b", None)])
def test_lm_loss_and_grads_match(name, vocab):
    """Three loss chunks of 8, labels of -1, a padded vocab tail (200 and
    250 of 256; gemma3 ties its embeddings) and deepseek's MoE aux.  f32:
    loss within 1e-5, every gradient within 1e-5 + 1e-4 relative."""
    cfg, tcfg, params, tparams = setup(name, vocab)
    toks, labels = batch(cfg, (2, 24))
    loss_fn = lambda p: ref_T.lm_loss(p, jnp.asarray(toks),
                                      jnp.asarray(labels), cfg, REF_CTX)
    want, want_g = jax.jit(jax.value_and_grad(loss_fn))(params)
    leaves, structure = bridge.tree_flatten(tparams)
    leaves = [a.requires_grad_() for a in leaves]
    got = T.lm_loss(bridge.tree_unflatten(structure, leaves),
                    torch.from_numpy(toks), torch.from_numpy(labels), tcfg,
                    ctx())
    assert got.dtype == torch.float32 and got.shape == ()
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    leaves_close(want_g, bridge.tree_unflatten(structure, list(grads)),
                 rtol=1e-4, atol=1e-5)


def test_lm_loss_masks_the_vocab_tail_and_rejects_a_ragged_chunk():
    cfg, tcfg, _, tparams = setup("granite-3-8b", vocab=200)
    toks, labels = batch(cfg, (1, 16))
    base = T.lm_loss(tparams, torch.from_numpy(toks),
                     torch.from_numpy(labels), tcfg, ctx())
    tparams["unembed"][:, 200:] += 100.0        # the tail is never read
    again = T.lm_loss(tparams, torch.from_numpy(toks),
                      torch.from_numpy(labels), tcfg, ctx())
    assert torch.equal(base, again)
    with pytest.raises(ValueError):
        T.lm_loss(tparams, torch.from_numpy(toks[:, :12]),
                  torch.from_numpy(labels[:, :12]), tcfg, ctx())


def grads_of(tcfg, tparams, toks, labels, c, frontend=None):
    leaves, structure = bridge.tree_flatten(tparams)
    leaves = [a.detach().clone().requires_grad_() for a in leaves]
    loss = T.lm_loss(bridge.tree_unflatten(structure, leaves),
                     torch.from_numpy(toks), torch.from_numpy(labels), tcfg,
                     c, frontend=frontend)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", ["gemma3-4b", "hymba-1.5b",
                                  "deepseek-moe-16b", "whisper-large-v3"])
def test_remat_is_bit_identical(name):
    """Layer, loss-chunk and q-block checkpoints change no bit of the loss
    or of any gradient (the band path through gemma3's and hymba's
    windows, the SSD scan, the MoE dispatch, whisper's encoder)."""
    cfg, tcfg, _, tparams = setup(name)
    toks, labels = batch(cfg, (2, 24))
    fe = None
    if cfg.n_frontend_tokens:
        fe = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    l0, g0 = grads_of(tcfg, tparams, toks, labels, ctx(False), fe)
    l1, g1 = grads_of(tcfg, tparams, toks, labels, ctx(True), fe)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_checkpoints_only_under_autograd(monkeypatch):
    """Serving (no tensor needs a gradient) never checkpoints, whatever
    ``remat`` says; training with it does."""
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg, tcfg, _, tparams = setup("granite-3-8b")
    toks, labels = batch(cfg, (1, 16))
    T.lm_loss(tparams, torch.from_numpy(toks), torch.from_numpy(labels),
              tcfg, ctx(True))
    assert not calls
    grads_of(tcfg, tparams, toks, labels, ctx(True))
    assert len(calls) == cfg.n_layers + 2          # layers + 2 loss chunks


def ref_step(cfg, tcfg, params, toks, labels, frontend=None):
    step = jax.jit(ref_make_step(cfg, REF_CTX, tcfg,
                                 has_frontend=frontend is not None))
    args = [params, ref_optim.init(params), jnp.asarray(toks),
            jnp.asarray(labels)]
    if frontend is not None:
        args.append(jnp.asarray(frontend))
    return step(*args)


def port_step(tcfg_arch, tcfg, tparams, toks, labels, frontend=None, c=None):
    step = make_train_step(tcfg_arch, c or ctx(), tcfg,
                           has_frontend=frontend is not None)
    args = [tparams, optim.init(tparams), torch.from_numpy(toks),
            torch.from_numpy(labels)]
    if frontend is not None:
        args.append(torch.from_numpy(frontend))
    return step(*args)


VARIANTS = {   # (compute dtype, grad dtype)
    "f32": (jnp.float32, jnp.float32, torch.float32, torch.float32),
    "bf16-compute": (jnp.bfloat16, jnp.float32, torch.bfloat16, torch.float32),
    "bf16-grads": (jnp.float32, jnp.bfloat16, torch.float32, torch.bfloat16),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches(variant):
    """h2o-danube (the reference's compression test arch), 2 microbatches:
    loss, lr, grad norm, the step and both moments against the JAX step.
    f32: 1e-5; bf16 compute or grads: loss 1e-2, grad norm 2e-2, moments
    within 3% of each leaf's largest.  Updated params as
    ``torch_train_parity.assert_update_close``."""
    jc, jg, tc, tg = VARIANTS[variant]
    cfg, tcfg, params, tparams = setup("h2o-danube-3-4b")
    toks, labels = batch(cfg, (2, 2, 16))
    adamw = dict(lr=1e-3, warmup_steps=0)
    rp, rs, rm = ref_step(cfg, RefTrainConfig(
        microbatches=2, compute_dtype=jc, grad_dtype=jg,
        adamw=ref_optim.AdamWConfig(**adamw)), params, toks, labels)
    tp, ts, tm = port_step(tcfg, TrainConfig(
        microbatches=2, compute_dtype=tc, grad_dtype=tg,
        adamw=optim.AdamWConfig(**adamw)), tparams, toks, labels)
    f32 = variant == "f32"
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5 if f32 else 2e-2)
    assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(ts.step) == int(rs.step) == 1
    for want, got in ((rs.mu, ts.mu), (rs.nu, ts.nu)):
        for w, g in zip(jax.tree.leaves(want),
                        bridge.tree_flatten(bridge.to_numpy(got))[0]):
            w = np.asarray(w)
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(
                g, w, atol=(1e-5 if f32 else 3e-2) * scale + 1e-30,
                rtol=1e-4 if f32 else 0)
    for w, g, mu in zip(jax.tree.leaves(rp),
                        bridge.tree_flatten(bridge.to_numpy(tp))[0],
                        jax.tree.leaves(rs.mu)):
        assert_update_close(w, g, mu, adamw["lr"], f32)


def test_grad_compression_bf16_matches_fp32_closely():
    """The reference's test, on the port: bf16 gradient accumulation keeps
    the grad norm within 5% of f32's."""
    cfg, tcfg, _, tparams = setup("h2o-danube-3-4b")
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    toks, labels = next(ds)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        step = make_train_step(tcfg, ctx(q_block=16), TrainConfig(
            microbatches=2, compute_dtype=torch.float32, grad_dtype=dtype,
            adamw=optim.AdamWConfig(lr=1e-3)))
        _, _, m = step(tparams, optim.init(tparams),
                       torch.from_numpy(toks).reshape(2, 2, -1),
                       torch.from_numpy(labels).reshape(2, 2, -1))
        out[dtype] = float(m["grad_norm"])
    a, b = out.values()
    assert abs(a - b) / max(a, 1e-9) < 0.05


def test_step_leaves_its_inputs_and_checks_microbatches():
    cfg, tcfg, _, tparams = setup("granite-3-8b")
    toks, labels = batch(cfg, (2, 1, 16))
    before = [a.clone() for a in bridge.tree_flatten(tparams)[0]]
    state = optim.init(tparams)
    step = make_train_step(tcfg, ctx(), TrainConfig(
        microbatches=2, compute_dtype=torch.float32))
    new, _, _ = step(tparams, state, torch.from_numpy(toks),
                     torch.from_numpy(labels))
    for a, b in zip(before, bridge.tree_flatten(tparams)[0]):
        assert torch.equal(a, b) and not b.requires_grad
    assert int(state.step) == 0
    assert not any(a.requires_grad for a in bridge.tree_flatten(new)[0])
    with pytest.raises(ValueError):
        step(tparams, state, torch.from_numpy(toks).reshape(1, 2, 16),
             torch.from_numpy(labels).reshape(1, 2, 16))


def test_fit_history_matches():
    """5 steps of phi3 with ``log_every=1``: each step's loss, grad norm and
    lr against the reference's ``fit`` (f32; the steps compound, so 1e-4)."""
    cfg, tcfg, params, tparams = setup("phi3-mini-3.8b")
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=4)
    _, _, want = ref_fit(params, cfg, REF_CTX, RefTrainConfig(
        microbatches=2, compute_dtype=jnp.float32,
        adamw=ref_optim.AdamWConfig(**adamw)), RefDataset(
            RefDataConfig(**data)), n_steps=5, log_every=1)
    _, state, got = fit(tparams, tcfg, ctx(), TrainConfig(
        microbatches=2, compute_dtype=torch.float32,
        adamw=optim.AdamWConfig(**adamw)), TrainDataset(DataConfig(**data)),
        n_steps=5, log_every=1)
    assert int(state.step) == 5
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(5))
    for w, g in zip(want, got):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)


def test_loss_decreases():
    """The reference's ``test_loss_decreases``, on the port."""
    cfg, tcfg, _, tparams = setup("phi3-mini-3.8b")
    tc = TrainConfig(microbatches=2, compute_dtype=torch.float32,
                     adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=5,
                                             total_steps=60))
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    _, _, hist = fit(tparams, tcfg, T.ParallelCtx(
        remat=False, q_block=16, kv_block=16, loss_chunk=16,
        compute_dtype=torch.float32), tc, ds, n_steps=40, log_every=10)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1


def ssd_inputs(dtype, s=40, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    x, bm, cm = r(2, s, 4, 8), r(2, s, 2, 6), r(2, s, 2, 6)
    dt = torch.nn.functional.softplus(r(2, s, 4) - 1)
    a = -torch.exp(r(4))
    return [x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_function_backward_matches_autograd(dtype, use_state):
    """``SSDScan`` applied with the plain forward on the CPU: the same
    outputs and, from its recomputing backward, the same gradients for x,
    dt, A, B and C as differentiating the plain scan directly (bit for
    bit: the backward differentiates the same graph), each in its input's
    dtype; with and without a cotangent on h_final."""
    chunk = 8
    direct = [t.clone().requires_grad_() for t in ssd_inputs(dtype)]
    wrapped = [t.clone().requires_grad_() for t in ssd_inputs(dtype)]
    y0, h0 = ssd.ssd_scan_plain(*direct, chunk)
    y1, h1 = ssd.SSDScan.apply(ssd.ssd_scan_plain, *wrapped, chunk)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    wy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        y0.shape).astype(np.float32))
    loss0 = (y0 * wy).sum() + (h0.square().sum() if use_state else 0)
    loss1 = (y1 * wy).sum() + (h1.square().sum() if use_state else 0)
    g0 = torch.autograd.grad(loss0, direct)
    g1 = torch.autograd.grad(loss1, wrapped)
    for a, b, t in zip(g0, g1, wrapped):
        assert b.dtype == t.dtype
        assert torch.equal(a, b)


def test_ssd_function_returns_grads_only_where_asked():
    x, dt, a, bm, cm = ssd_inputs(torch.float32)
    x.requires_grad_()
    y, _ = ssd.SSDScan.apply(ssd.ssd_scan_plain, x, dt, a, bm, cm, 8)
    (gx,) = torch.autograd.grad(y.sum(), [x])
    ref = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(
        ssd.ssd_scan_plain(ref, dt, a, bm, cm, 8)[0].sum(), [ref])
    assert torch.equal(gx, want)
