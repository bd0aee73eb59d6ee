"""AdamW of the port against the JAX reference (CPU): the warmup-cosine
schedule, the global norm and its clipping, and ``update`` over several
steps on a tree of 1-D, 2-D, stacked and bf16 leaves, with clipping active
and inactive, from step 0 and from a reference state at step 3 carried
over by the bridge."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1)
# f32 math in both packages, summed or rounded in another order: a few ulps
F32_TOL = 1e-6
BF16_ULP = 2.0 ** -7           # one bf16 rounding step, relative


def tree(seed, scale=1.0):
    """A reference-style tree: a 2-D and a stacked 3-D weight, a 1-D norm,
    a list of leaves, a bf16 2-D weight and a bf16 1-D leaf."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": r(6, 5), "stack": r(3, 4, 2), "norm": r(7),
            "layers": [{"a": r(4, 4)}, {"a": r(4, 4), "b": r(4)}],
            "bf": jnp.asarray(r(5, 3), jnp.bfloat16),
            "bf1": jnp.asarray(r(9), jnp.bfloat16)}


def ref_tree(t):
    return jax.tree.map(jnp.asarray, t)


def assert_tree_close(want, got, tol=F32_TOL):
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    w_leaves, w_def = jax.tree.flatten(want)
    g_leaves, g_def = bridge.tree_flatten(bridge.to_numpy(got))
    assert len(w_leaves) == len(g_leaves)
    for w, g in zip(w_leaves, g_leaves):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 6, 10, 25])
def test_schedule_matches(step):
    """Steps 0 and 1, the warmup's end (3), mid-decay, the total and beyond."""
    cfg = ref_optim.AdamWConfig(**CFG)
    want = float(ref_optim.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = optim.schedule(optim.AdamWConfig(**CFG),
                         torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=F32_TOL)


def test_schedule_zero_warmup_and_floor():
    for kw in (dict(warmup_steps=0, total_steps=4), dict(total_steps=3)):
        cfg = dict(CFG, **kw)
        for step in (0, 1, 4, 9):
            want = float(ref_optim.schedule(ref_optim.AdamWConfig(**cfg),
                                            jnp.asarray(step, jnp.int32)))
            got = float(optim.schedule(optim.AdamWConfig(**cfg),
                                       torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=F32_TOL)


def test_global_norm_and_clip_match():
    g = tree(1)
    want = float(ref_optim.global_norm(ref_tree(g)))
    tg = bridge.to_torch(g, "cpu")
    np.testing.assert_allclose(float(optim.global_norm(tg)), want,
                               rtol=F32_TOL)
    for max_norm in (0.5, 1e6):
        w_tree, w_norm = ref_optim.clip_by_global_norm(ref_tree(g), max_norm)
        g_tree, g_norm = optim.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(g_norm), float(w_norm), rtol=F32_TOL)
        assert_tree_close(w_tree, g_tree, tol=BF16_ULP)


def test_init_matches():
    state = optim.init(bridge.to_torch(tree(0), "cpu"))
    ref = ref_optim.init(ref_tree(tree(0)))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert_tree_close(ref.mu, state.mu, tol=0)
    for leaf in bridge.tree_flatten(state.nu)[0]:
        assert leaf.dtype == torch.float32


def run_both(clip_norm, n_steps, start_steps=0):
    """``n_steps`` updates in both packages on the same numpy-seeded grads,
    after ``start_steps`` reference updates carried over by the bridge."""
    cfg = dict(CFG, clip_norm=clip_norm)
    rcfg, tcfg = ref_optim.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    params = ref_tree(tree(0))
    state = ref_optim.init(params)
    for s in range(start_steps):
        params, state, _ = ref_optim.update(rcfg, params, ref_tree(
            tree(100 + s, 0.1)), state)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    tstate = bridge.opt_state_to_torch(jax.tree.map(np.asarray, state), "cpu")
    for s in range(n_steps):
        grads = tree(200 + s, 0.1)
        params, state, m = ref_optim.update(rcfg, params, ref_tree(grads),
                                            state)
        tparams, tstate, tm = optim.update(tcfg, tparams,
                                           bridge.to_torch(grads, "cpu"),
                                           tstate)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(m[k]),
                                       rtol=F32_TOL)
        assert int(tstate.step) == int(state.step)
        assert tstate.step.dtype == torch.int32
        # bf16 leaves round the f32 update once: allow one bf16 step
        assert_tree_close(params, tparams, tol=BF16_ULP)
        assert_tree_close(state.mu, tstate.mu)
        assert_tree_close(state.nu, tstate.nu)
        f32 = [(a, b) for a, b in zip(jax.tree.leaves(params),
                                      bridge.tree_flatten(tparams)[0])
               if b.dtype == torch.float32]
        for a, b in f32:
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=F32_TOL, atol=F32_TOL)
    return tparams, tstate


@pytest.mark.parametrize("clip_norm", [0.05, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("start_steps", [0, 3])
def test_update_matches(clip_norm, start_steps):
    tparams, _ = run_both(clip_norm, n_steps=4, start_steps=start_steps)
    assert bridge.tree_flatten(tparams)[0][0].dtype == torch.bfloat16  # "bf"


def test_update_keeps_dtypes_and_decays_only_matrices():
    """Zero grads: the only change is weight decay, on >= 2-D leaves."""
    t = bridge.to_torch(tree(0), "cpu")
    zeros = bridge.tree_map(torch.zeros_like, t)
    new, state, _ = optim.update(optim.AdamWConfig(**dict(CFG, warmup_steps=0)),
                                 t, zeros, optim.init(t))
    for a, b in zip(bridge.tree_flatten(t)[0], bridge.tree_flatten(new)[0]):
        assert a.dtype == b.dtype
        if a.ndim < 2:
            assert torch.equal(a, b)
        elif a.dtype == torch.float32:
            assert not torch.equal(a, b)
    assert int(state.step) == 1


def test_opt_state_round_trips_through_numpy():
    state = optim.init(bridge.to_torch(tree(0), "cpu"))
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    back = bridge.opt_state_to_torch(bridge.opt_state_to_numpy(state), "cpu")
    assert isinstance(back, optim.AdamWState)
    assert back.step.dtype == torch.int32 and int(back.step) == 7
    for a, b in zip(bridge.tree_flatten(state)[0], bridge.tree_flatten(back)[0]):
        assert torch.equal(a, b)


def test_tree_flatten_order_is_jax_order():
    t = tree(3)
    t["z"] = (np.float32(1.0), None, [np.float32(2.0)])
    w_leaves = jax.tree.leaves(t)
    leaves, structure = bridge.tree_flatten(t)
    assert len(leaves) == len(w_leaves)
    for a, b in zip(w_leaves, leaves):
        assert a is b
    back = bridge.tree_unflatten(structure, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(t)
    with pytest.raises(ValueError):
        bridge.tree_unflatten(structure, leaves + [1])


def test_a_step_frees_its_inputs_without_the_garbage_collector():
    """Once the caller drops the old params, moments and grads, nothing of
    the update keeps them: no reference cycle holds a leaf until a
    collection (at full width that cost a step's whole state, 32 GB)."""
    import gc
    import weakref
    t = bridge.to_torch(tree(0), "cpu")
    state = optim.init(t)
    grads = bridge.to_torch(tree(1, 0.1), "cpu")
    refs = [weakref.ref(a) for a in bridge.tree_flatten((t, state, grads))[0]]
    gc.disable()
    try:
        new = optim.update(optim.AdamWConfig(**CFG), t, grads, state)
        back = bridge.tree_unflatten(*reversed(bridge.tree_flatten(new)))
        del t, state, grads
        assert all(r() is None for r in refs)
        assert back is not None
    finally:
        gc.enable()


ZERO1_CASES = [
    # (param placement, shape, dp axes, dp size)
    ((None, "model"), (8, 4), ("data",), 4),           # the first whole dim
    ((None, "model"), (6, 4), ("data",), 4),           # 6 % 4: no dim left
    ((None, None, "model"), (3, 8, 4), ("data",), 4),  # skips a dim of 3
    (("model", None), (8, 16), ("pod", "data"), 32),   # 16 % 32: kept
    (("model", None), (8, 64), ("pod", "data"), 32),   # a tuple entry
    ((None,), (64,), ("data",), 16),                   # a 1-D leaf
    ((None,), (0,), ("data",), 2),                     # an empty dim
]


@pytest.mark.parametrize("spec,shape,dp_axes,dp_size", ZERO1_CASES)
def test_zero1_specs_match(spec, shape, dp_axes, dp_size):
    """The moments' placements: the first dim the parameter's placement
    leaves whole and the DP degree divides, cut over the batch axes."""
    from jax.sharding import PartitionSpec as P
    tree = {"a": [np.zeros(shape, np.float32)], "b": np.zeros((4,), np.float32)}
    specs = {"a": [spec], "b": (None,)}
    want = ref_optim.zero1_specs(
        {"a": [P(*spec)], "b": P(None)}, tree, dp_axes, dp_size)
    got = optim.zero1_specs(specs, tree, dp_axes, dp_size)
    assert got == jax.tree.map(tuple, want, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("zero1", [False, True])
def test_update_sharded_on_one_rank_is_update(zero1):
    """On a mesh of one rank every collective is the identity, so the
    sharded update (``reduce_grads`` then ``update_sharded``) is ``update``
    bit for bit, with ZeRO-1 placements or without."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 1), ("data", "model"), rank=0)
    params = bridge.to_torch(tree(0), "cpu")
    grads = bridge.to_torch(tree(1, scale=3.0), "cpu")
    specs = bridge.tree_map(lambda a: (None,) * a.ndim, params)
    mspecs = optim.zero1_specs(specs, params, ("data",), 1) if zero1 else specs
    state = optim.init(params)
    want_p, want_s, want_m = optim.update(optim.AdamWConfig(**CFG), params,
                                          grads, state)
    placed = dict(mesh=mesh, param_specs=specs, moment_specs=mspecs)
    flat = optim.reduce_grads(bridge.tree_map(torch.clone, grads),
                              batch_axes=("data",), **placed)
    got_p, got_s, got_m = optim.update_sharded(optim.AdamWConfig(**CFG), params,
                                               flat, state, **placed)
    for a, b in zip(bridge.tree_flatten((want_p, want_s, want_m))[0],
                    bridge.tree_flatten((got_p, got_s, got_m))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
