"""The port's sharded serve step (``repro_torch.launch.serve_step``) on 4
gloo ranks (a 2x2 data x model mesh) against the reference's
``make_serve_step`` on a 2x2 Auto mesh of fake CPU devices, in f32:

* reduced granite-3-8b, and reduced gemma3-4b at 6 layers (its 2 reduced
  layers are both sliding-window and would never touch a paged layer), 8
  teacher-forced steps from the same params and caches: tokens equal at
  every step, logits and the final caches within 1e-5;
* one migration step: pools bit-equal to the reference's ``ppermute``;
* the other kinds (SSM, hybrid, cross-attention, MoE; held against the
  reference in ``test_torch_launch_serve_kinds*.py``) build a step.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

ARCHS = (("granite-3-8b", 0), ("gemma3-4b", 6))
TOL = 1e-5
MESH = (2, 2)
N_MIG = 3

REFERENCE = """
from repro.configs import ARCHS, reduced, replace
from repro.configs.base import ShapeConfig
from repro.launch import serve_step as SS
from repro.models import transformer as T

inp = dict(np.load(IN))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
# the reference's step returns only the argmax: record the logits it read
captured = {}
mask = T.mask_vocab_pad
def capture(logits, cfg):
    captured["logits"] = mask(logits, cfg)
    return captured["logits"]
T.mask_vocab_pad = capture

for ai, (name, n_layers) in enumerate(%(archs)r):
    cfg = reduced(ARCHS[name])
    if n_layers:
        cfg = replace(cfg, n_layers=n_layers)
    shape = ShapeConfig(**%(shape)r)
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",), page=%(page)d)
    fn, plan, ctx = SS.make_serve_step(cfg, shape, mesh, plan=plan,
                                       compute_dtype=jnp.float32)
    structs = SS.decode_struct(cfg, shape, mesh, plan, dtype=jnp.float32)[0]
    params = jax.tree.map(np.asarray, T.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1 + ai)
    caches = [{k: rng.normal(size=s.shape).astype(np.float32)
               for k, s in c.items()} for c in structs]
    out.update(flatten(params, f"{name}/params"))
    out.update(flatten(caches, f"{name}/caches0"))
    if ai == 0:
        seg = next(i for i, c in enumerate(caches) if "pool_k" in c)
        mig = jax.jit(SS.make_migrate_step(mesh, plan, None))
        pk, pv = mig(caches[seg]["pool_k"], caches[seg]["pool_v"],
                     inp["mig_src"], inp["mig_dst"])
        out["migrate/pool_k"], out["migrate/pool_v"] = np.asarray(pk), np.asarray(pv)

    def step_fn(params, caches, step):
        toks, caches = fn(params, caches, step)
        return toks, caches, captured["logits"]
    step_fn = jax.jit(step_fn)
    c = caches
    for t in range(%(steps)d):
        step = {"tokens": inp[f"{name}/tokens"][t],
                "block_table": inp["block_table"],
                **{k: inp[f"step{t}/{k}"] for k in
                   ("app_slot", "app_off", "app_rank", "lengths")}}
        toks, c, logits = step_fn(params, c, step)
        out[f"{name}/tokens/{t}"] = np.asarray(toks)
        out[f"{name}/logits/{t}"] = np.asarray(logits)
    out.update(flatten(jax.tree.map(np.asarray, c), f"{name}/caches"))
np.savez(OUT, **out)
""" % dict(archs=ARCHS, shape=lp.SERVE_SHAPE, page=lp.SERVE_PAGE,
           steps=lp.STEPS)


def _geometry():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(MESH, ("data", "model"))
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",),
                         page=lp.SERVE_PAGE)
    shape = ShapeConfig(**lp.SERVE_SHAPE)
    return mesh, plan, shape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import serve_step as SS
    wd = tmp_path_factory.mktemp("launch_serve")
    mesh, plan, shape = _geometry()
    geo = SS.cache_geometry(lp.serve_config(*ARCHS[0]), shape, mesh, plan)
    bt, steps = lp.step_inputs(lp.LENGTHS0, lp.STEPS, dp=geo["dp"],
                               kvr=geo["kvr"], page=plan.page,
                               p_loc=geo["p_loc"], slots=geo["slots_loc"])
    rng = np.random.default_rng(0)
    inputs = {"block_table": bt}
    for t, st in enumerate(steps):
        inputs.update({f"step{t}/{k}": v for k, v in st.items()})
    for name, n_layers in ARCHS:
        vocab = lp.serve_config(name, n_layers).vocab
        inputs[f"{name}/tokens"] = rng.integers(
            0, vocab, size=(lp.STEPS, shape.global_batch)).astype(np.int32)
    # per (data, model) rank: move N_MIG pages to distinct slots
    inputs["mig_src"] = np.stack([np.stack([
        rng.permutation(geo["slots_loc"])[:N_MIG] for _ in range(MESH[1])])
        for _ in range(MESH[0])]).astype(np.int32)
    inputs["mig_dst"] = np.stack([np.stack([
        rng.permutation(geo["slots_loc"])[:N_MIG] for _ in range(MESH[1])])
        for _ in range(MESH[0])]).astype(np.int32)
    np.savez(wd / "inputs.npz", **inputs)
    ref = lp.run_reference(REFERENCE, 4, wd)
    lp.spawn_ranks(lp.serve_rank, 4, str(wd), ARCHS)
    port = [dict(np.load(lp.rank_out(wd, r))) for r in range(4)]
    return ref, port


def _global(port, key, spec, shape):
    return lp.assemble([p[key] for p in port], spec, MESH, shape)


@pytest.mark.parametrize("step", range(lp.STEPS))
@pytest.mark.parametrize("name", [a for a, _ in ARCHS])
def test_tokens_equal_every_step(runs, name, step):
    ref, port = runs
    want = ref[f"{name}/tokens/{step}"]
    got = _global(port, f"{name}/tokens/{step}", ("data",), want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", range(lp.STEPS))
@pytest.mark.parametrize("name", [a for a, _ in ARCHS])
def test_logits_within_tolerance(runs, name, step):
    ref, port = runs
    want = ref[f"{name}/logits/{step}"]
    got = _global(port, f"{name}/logits/{step}", ("data", None), want.shape)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


@pytest.mark.parametrize("name", [a for a, _ in ARCHS])
def test_caches_within_tolerance(runs, name):
    from repro_torch.launch import serve_step as SS
    ref, port = runs
    mesh, plan, shape = _geometry()
    cfg = lp.serve_config(name, dict(ARCHS)[name])
    _, specs, _, _, _ = SS.decode_struct(cfg, shape, mesh, plan)
    want = lp.unflatten(ref, f"{name}/caches")
    assert len(want) == len(specs)
    for si, (c, sp) in enumerate(zip(want, specs)):
        assert set(c) == set(sp)
        for key, w in c.items():
            got = _global(port, f"{name}/caches/{si}/{key}", sp[key], w.shape)
            err = float(np.abs(got - w).max())
            assert err <= TOL, (si, key, err)


@pytest.mark.parametrize("key", ["pool_k", "pool_v"])
def test_migrate_step_bit_equal(runs, key):
    ref, port = runs
    want = ref[f"migrate/{key}"]
    spec = (None, "data", "model", None, None, None, None)
    got = _global(port, f"migrate/{key}", spec, want.shape)
    np.testing.assert_array_equal(got, want)
    # the step did move pages: the destination slots changed
    before = ref[f"{ARCHS[0][0]}/caches0/0/{key}"]
    assert not np.array_equal(before, want)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b",
                                  "deepseek-moe-16b", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-11b", "whisper-large-v3"])
def test_other_kinds_wait_for_13b(name):
    """ROADMAP item 13b is in: the serve step builds for every kind.  (The
    name is from when these kinds waited for 13b.)"""
    from repro_torch.configs import ARCHS as T_ARCHS, reduced
    from repro_torch.launch import serve_step as SS
    mesh, plan, shape = _geometry()
    fn, got_plan, ctx = SS.make_serve_step(reduced(T_ARCHS[name]), shape, mesh,
                                           plan=plan)
    assert callable(fn) and got_plan == plan
    assert ctx.dp_axes == plan.batch_axes and ctx.mesh is mesh
