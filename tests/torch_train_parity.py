"""The train half of ``tests/test_arch_smoke.py`` held against the port:
one microbatched train step of a reduced arch in both packages from the
same params, tokens, labels and frontend (``test_torch_arch_train*.py``)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import optim as ref_optim
from repro.configs import ARCHS, reduced
from repro.models import transformer as ref_T
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_make_step
from repro_torch import bridge, optim
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import transformer as T
from repro_torch.train import TrainConfig, make_train_step

from torch_parity import frontend_for, open_xgates

REF_CTX = ref_T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8,
                            compute_dtype=jnp.float32)
CTX = T.ParallelCtx(remat=True, q_block=8, kv_block=8, loss_chunk=8,
                    compute_dtype=torch.float32)
LR = 1e-3
VARIANTS = {   # compute dtype, grad dtype (reference, port)
    "f32": (jnp.float32, jnp.float32, torch.float32, torch.float32),
    "bf16-compute": (jnp.bfloat16, jnp.float32, torch.bfloat16, torch.float32),
    "bf16-grads": (jnp.float32, jnp.bfloat16, torch.float32, torch.bfloat16),
}


def assert_update_close(want, got, mu, lr, f32, eps=1e-8, b1=0.9):
    """Params after one AdamW step from the same params.  The step moves an
    entry by lr g / (|g| + eps) (plus the same decay on both sides), g the
    clipped gradient (= mu / (1 - b1)).  In f32, where |g| >= 100 eps the
    move is well conditioned: held within 1e-3 lr; below, a rounding of g
    can move it by up to lr: held within 2 lr.  With bf16 compute or
    gradients a small gradient's sign may flip anywhere: 2 lr."""
    g = np.abs(np.asarray(mu, np.float32)) / (1 - b1)
    tol = np.where(g >= 100 * eps, 1e-3 * lr, 2 * lr) if f32 else 2 * lr
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.all(err <= tol), float(np.max(err - tol))


def check_arch_step(name, variant):
    """One step, 2 microbatches of 1 x 16 tokens (as ``test_arch_smoke``),
    the cross archs with an opened gate and a numpy frontend.  The port runs
    with remat on, the reference with it off (remat changes no bit).
    Tolerances: f32 loss and grad norm 1e-5, the first moment (0.1 g, so
    the gradients) within 1e-4 of each leaf's largest entry; bf16 compute or
    gradients: loss 1e-2, grad norm 3e-2, first moment within 5% of each
    leaf's largest; the updated params as ``assert_update_close``."""
    jc, jg, tc, tg = VARIANTS[variant]
    cfg = reduced(ARCHS[name])
    params = open_xgates(ref_T.init_params(jax.random.PRNGKey(0), cfg))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(2, 1, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(2, 1, 16)).astype(np.int32)
    fe = frontend_for(cfg, 2)
    adamw = dict(lr=LR, warmup_steps=0)
    ref = jax.jit(ref_make_step(cfg, REF_CTX, RefTrainConfig(
        microbatches=2, compute_dtype=jc, grad_dtype=jg,
        adamw=ref_optim.AdamWConfig(**adamw)), has_frontend=fe is not None))
    port = make_train_step(t_reduced(T_ARCHS[name]), CTX, TrainConfig(
        microbatches=2, compute_dtype=tc, grad_dtype=tg,
        adamw=optim.AdamWConfig(**adamw)), has_frontend=fe is not None)
    rargs = [params, ref_optim.init(params), jnp.asarray(toks),
             jnp.asarray(labels)]
    targs = [tparams, optim.init(tparams), torch.from_numpy(toks),
             torch.from_numpy(labels)]
    if fe is not None:
        rargs.append(jnp.asarray(fe.reshape(2, 1, *fe.shape[1:])))
        targs.append(torch.from_numpy(fe.reshape(2, 1, *fe.shape[1:])))
    rp, rs, rm = ref(*rargs)
    tp, ts, tm = port(*targs)

    f32 = variant == "f32"
    assert np.isfinite(float(tm["loss"])) and np.isfinite(float(tm["grad_norm"]))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5 if f32 else 3e-2)
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(rp)]
    got = bridge.tree_flatten(bridge.to_numpy(tp))[0]
    old = bridge.tree_flatten(bridge.to_numpy(tparams))[0]
    assert len(want) == len(got)
    moved = 0.0
    for w, g, o, mu in zip(want, got, old, jax.tree.leaves(rs.mu)):
        assert_update_close(w, g, mu, LR, f32)
        moved += float(np.abs(g - o).sum())
    assert moved > 0                               # params actually changed
    for w, g in zip(jax.tree.leaves(rs.mu),
                    bridge.tree_flatten(bridge.to_numpy(ts.mu))[0]):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=(1e-4 if f32 else 5e-2) * float(np.abs(w).max()))
