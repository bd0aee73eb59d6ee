"""Shared helpers of the launch-layer parity tests (``test_torch_launch_*.py``).

The reference's sharded path runs in a subprocess with fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) on a mesh with
Auto axes (``jax.sharding.Mesh`` over the reshaped device list; under jax
0.9 ``jax.make_mesh`` builds Explicit axes, which ``with_sharding_constraint``
rejects).  It hands its arrays back through an ``.npz``.  The port's side
runs as gloo ranks spawned here, each on its local shards; each rank saves
what it computed, and the parent puts the global arrays back together.
Every run has a time limit and fails rather than hangs.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
JOIN_SECONDS = 120

# step inputs of the serve-step tests: batch 4 over data 2, pages of 4 over
# model 2, 8 teacher-forced steps from these lengths (test_sharding.py's
# pattern: page pg of sequence b on KV rank pg % kvr, local page pg // kvr)
LENGTHS0 = (21, 13, 30, 9)
STEPS = 8


# --------------------------------------------------------------------------
# Trees <-> flat npz keys
# --------------------------------------------------------------------------

def flatten(tree, prefix):
    """{"prefix/a/0/b": array} for a tree of dicts and lists."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            out[path] = np.asarray(t)
    walk(tree, prefix)
    return out


def unflatten(arrays, prefix):
    """Inverse of ``flatten`` (dicts with keys 0..n-1 become lists)."""
    root = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(a)

    def fix(t):
        if not isinstance(t, dict):
            return t
        t = {k: fix(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return fix(root)


# --------------------------------------------------------------------------
# The reference, in a subprocess with fake devices
# --------------------------------------------------------------------------

PRELUDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from torch_launch_parity import flatten, unflatten
"""


def run_reference(body: str, n_devices: int, workdir: Path,
                  timeout: int = 240) -> dict:
    """Run ``body`` after ``PRELUDE`` with ``n_devices`` fake devices; it
    reads ``IN`` (a path) and writes ``OUT`` (an npz); returns OUT's
    arrays."""
    script = workdir / "reference.py"
    out = workdir / "reference_out.npz"
    script.write_text(PRELUDE.format(n=n_devices, src=SRC,
                                     tests=str(ROOT / "tests"))
                      + f"IN = {str(workdir / 'inputs.npz')!r}\n"
                      + f"OUT = {str(out)!r}\n" + textwrap.dedent(body))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=timeout, env=env, cwd=workdir)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


# --------------------------------------------------------------------------
# The port, as gloo ranks
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, seconds: int = JOIN_SECONDS):
    """Run ``fn(rank, *args)`` in ``world`` spawned gloo ranks; fail if one
    raises or the ranks outlast ``seconds`` (they are killed then)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, _free_port(), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"{world} ranks outlasted {seconds} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def rank_out(workdir: Path, rank: int) -> Path:
    return workdir / f"rank{rank}.npz"


def mesh_coords(rank, shape):
    return dict(zip(("data", "model"), np.unravel_index(rank, shape)))


def assemble(per_rank, spec, mesh_shape, global_shape):
    """The global array from each rank's block under ``spec`` (a placement
    tuple); replicated copies must agree bit for bit."""
    names = ("data", "model")
    sizes = dict(zip(names, mesh_shape))
    out = np.full(global_shape, np.nan, dtype=per_rank[0].dtype) \
        if per_rank[0].dtype.kind == "f" else np.zeros(global_shape, per_rank[0].dtype)
    seen = {}
    lead = len(global_shape) - len(spec)
    for rank, block in enumerate(per_rank):
        coords = mesh_coords(rank, mesh_shape)
        index = [slice(None)] * lead
        for dim, axes in enumerate(spec, start=lead):
            if axes is None:
                index.append(slice(None))
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            n, i = 1, 0
            for a in names:
                if a in axes:
                    n, i = n * sizes[a], i * sizes[a] + coords[a]
            step = global_shape[dim] // n
            index.append(slice(i * step, (i + 1) * step))
        key = tuple((s.start, s.stop) for s in index)
        if key in seen:
            assert np.array_equal(seen[key], block, equal_nan=True), \
                f"replicas of block {key} differ"
        seen[key] = block
        out[tuple(index)] = block
    return out


# --------------------------------------------------------------------------
# Step inputs: pages round-robin over the KV ranks
# --------------------------------------------------------------------------

def step_inputs(lengths0, steps, *, dp, kvr, page, p_loc, slots):
    """Block table (dp, kvr, B_loc, p_loc) holding every page the sequences
    reach in ``steps`` steps, page pg of sequence b on KV rank pg % kvr as
    local page pg // kvr, slots handed out in order per (dp, rank); and per
    step the append targets (app_rank, app_slot, app_off) and lengths."""
    b = len(lengths0)
    b_loc = b // dp
    bt = np.full((dp, kvr, b_loc, p_loc), -1, np.int32)
    used = np.zeros((dp, kvr), int)
    for i in range(b):
        di, bl = divmod(i, b_loc)
        for pg in range((lengths0[i] + steps - 1) // page + 1):
            r, j = pg % kvr, pg // kvr
            bt[di, r, bl, j] = used[di, r]
            used[di, r] += 1
    assert used.max() <= slots, "more pages than slots"
    per_step = []
    for t in range(steps):
        cur = np.asarray(lengths0, np.int32) + t
        pg = cur // page
        rank = (pg % kvr).astype(np.int32)
        slot = np.array([bt[i // b_loc, rank[i], i % b_loc, pg[i] // kvr]
                         for i in range(b)], np.int32)
        per_step.append(dict(app_rank=rank, app_slot=slot,
                             app_off=(cur % page).astype(np.int32),
                             lengths=cur.astype(np.int32)))
    return bt, per_step


# --------------------------------------------------------------------------
# Rank bodies (module level: the spawned ranks import them from here)
# --------------------------------------------------------------------------

SERVE_SHAPE = dict(name="parity", seq_len=64, global_batch=4, kind="decode")
SERVE_PAGE = 4


def serve_config(name, n_layers):
    """The reduced arch ``name`` at ``n_layers`` (0: as reduced), or the
    config of a case dict (``case_config``)."""
    from repro_torch.configs import ARCHS, reduced, replace
    cfg = case_config(name) if isinstance(name, dict) else reduced(ARCHS[name])
    return replace(cfg, n_layers=n_layers) if n_layers else cfg


def serve_key(name):
    return name["tag"] if isinstance(name, dict) else name


def serve_rank(rank, workdir, archs, migrate=True):
    """One rank of the 2x2 serve-step run: every arch's STEPS teacher-forced
    steps on its shards of the reference's params and caches, and (with
    ``migrate``) one migration step on the first arch's first paged
    segment.  ``archs``: (arch name or case dict, n_layers) pairs."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import local_block, make_local_mesh
    from repro_torch.models import transformer as T

    workdir = Path(workdir)
    ref = dict(np.load(workdir / "reference_out.npz"))
    inp = dict(np.load(workdir / "inputs.npz"))
    mesh = make_local_mesh(2, 2)
    shape = ShapeConfig(**SERVE_SHAPE)
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",),
                         page=SERVE_PAGE)
    out = {}

    def local(a, spec):
        return torch.from_numpy(np.ascontiguousarray(local_block(a, spec, mesh)))

    for ai, (arch, n_layers) in enumerate(archs):
        cfg, name = serve_config(arch, n_layers), serve_key(arch)
        fn, _, _ = SS.make_serve_step(cfg, shape, mesh, plan=plan,
                                      compute_dtype=torch.float32)
        _, cspecs, _, sspecs, _ = SS.decode_struct(cfg, shape, mesh, plan,
                                                   dtype=torch.float32)
        params_np = unflatten(ref, f"{name}/params")
        params = bridge.shard_to_torch(
            params_np, T.param_pspecs(params_np, cfg, mesh.shape["model"]),
            mesh, device="cpu")
        caches = [{k: local(v, cs[k]) for k, v in c.items()}
                  for c, cs in zip(unflatten(ref, f"{name}/caches0"), cspecs)]
        if ai == 0 and migrate:
            seg = next(i for i, c in enumerate(caches) if "pool_k" in c)
            migrate = SS.make_migrate_step(mesh, plan)
            pk, pv = migrate(caches[seg]["pool_k"].clone(),
                             caches[seg]["pool_v"].clone(),
                             local(inp["mig_src"], ("data", "model", None)),
                             local(inp["mig_dst"], ("data", "model", None)))
            out["migrate/pool_k"], out["migrate/pool_v"] = pk.numpy(), pv.numpy()
        for t in range(STEPS):
            step = {"tokens": inp[f"{name}/tokens"][t],
                    "block_table": inp["block_table"],
                    **{k: inp[f"step{t}/{k}"] for k in
                       ("app_slot", "app_off", "app_rank", "lengths")}}
            step = {k: local(v, sspecs[k]) for k, v in step.items()}
            toks, caches, logits = fn(params, caches, step, with_logits=True)
            out[f"{name}/tokens/{t}"] = toks.numpy()
            out[f"{name}/logits/{t}"] = logits.numpy()
        out.update(flatten([{k: v.numpy() for k, v in c.items()}
                            for c in caches], f"{name}/caches"))
    np.savez(rank_out(workdir, rank), **out)


PAGED_MESH = (2, 4)


def paged_rank(rank, workdir):
    """One rank of the 2x4 run of ``_paged_attn_sharded``: the f32 pool and
    the int8 pool."""
    import torch
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import local_block, make_local_mesh

    workdir = Path(workdir)
    inp = dict(np.load(workdir / "inputs.npz"))
    ref = dict(np.load(workdir / "reference_out.npz"))
    mesh = make_local_mesh(*PAGED_MESH)
    pool_spec = ("data", "model", None, None, None, None)
    vec = ("data", None, None)

    def local(a, spec):
        return torch.from_numpy(np.ascontiguousarray(local_block(a, spec, mesh)))

    args = [local(inp["bt"], ("data", "model", None, None)),
            local(inp["q"], vec), local(inp["k"], vec), local(inp["v"], vec),
            *(local(inp[k], ("data",)) for k in
              ("app_slot", "app_off", "app_rank", "lengths"))]
    out = {}
    for kv_dtype in ("bf16", "int8"):
        plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",), page=4,
                             kv_dtype=kv_dtype)
        keys = ("pool_k", "pool_v") + (("scale_k", "scale_v")
                                       if kv_dtype == "int8" else ())
        cache = {k: local(ref[f"{kv_dtype}/in/{k}"],
                          pool_spec if k.startswith("pool") else pool_spec[:-1])
                 for k in keys}
        o = SS._paged_attn_sharded(cache, *args, mesh=mesh, plan=plan,
                                   out_dtype=torch.float32)
        out[f"{kv_dtype}/out"] = o.numpy()
        for k in keys:
            out[f"{kv_dtype}/{k}"] = cache[k].numpy()
    np.savez(rank_out(workdir, rank), **out)


# --------------------------------------------------------------------------
# The sharded prefill (``test_torch_launch_prefill*.py``)
# --------------------------------------------------------------------------

def case_config(case, package="repro_torch"):
    """A case's config in ``package``: the reduced arch, then the case's
    replacements (``ssm`` and ``moe`` given as dicts of their fields)."""
    import dataclasses
    import importlib
    configs = importlib.import_module(f"{package}.configs")
    cfg = configs.reduced(configs.ARCHS[case["arch"]])
    kw = dict(case.get("cfg", {}))
    for sub in ("ssm", "moe"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return dataclasses.replace(cfg, **kw)


def seq_parallel_rule(cfg, mp):
    """``build_prefill_cell``'s rule (both packages)."""
    if not cfg.n_heads:
        return True
    return cfg.n_heads % mp == 0 or cfg.n_heads == cfg.n_kv_heads


def prefill_inputs(cases, seed=0):
    """Per case: tokens (B, S) and, for an arch that reads one, a frontend
    (B, N, d), numpy-seeded."""
    rng = np.random.default_rng(seed)
    out = {}
    for case in cases:
        cfg = case_config(case)
        tag = case["tag"]
        out[f"{tag}/tokens"] = rng.integers(
            0, cfg.vocab, size=(case["batch"], case["seq"])).astype(np.int32)
        if cfg.n_frontend_tokens:
            out[f"{tag}/frontend"] = rng.standard_normal(
                (case["batch"], cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32)
    return out


# the reference's side: its sharded prefill_logits under jit, f32, with
# params, tokens and frontend placed as its prefill cell places them
PREFILL_REFERENCE = """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import transformer as T
from torch_launch_parity import case_config, seq_parallel_rule

inp = dict(np.load(IN))
out = {}
for case in CASES:
    tag = case["tag"]
    cfg = case_config(case, "repro")
    dp, mp = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("data", "model"))
    sp = case.get("sp")
    ctx = T.ParallelCtx(mesh=mesh, dp_axes=("data",), remat=False,
                        compute_dtype=jnp.float32,
                        seq_parallel=seq_parallel_rule(cfg, mp) if sp is None else sp)
    params = T.init_params(jax.random.PRNGKey(case.get("seed", 0)), cfg)
    if cfg.xattn_every:          # open the gates of the cross path
        params["segments"] = [dict(s, xgate=jnp.full_like(s["xgate"], 0.5))
                              if "xgate" in s else s for s in params["segments"]]
    out.update(flatten(jax.tree.map(np.asarray, params), f"{tag}/params"))
    place = lambda spec: NamedSharding(mesh, spec)
    specs = T.param_pspecs(params, cfg, model_size=mp)
    params = jax.device_put(params, jax.tree.map(
        place, specs, is_leaf=lambda s: isinstance(s, P)))
    args = [params, jax.device_put(inp[f"{tag}/tokens"], place(P("data", None)))]
    if f"{tag}/frontend" in inp:
        args.append(jax.device_put(inp[f"{tag}/frontend"],
                                   place(P("data", None, None))))
    fn = jax.jit(lambda p, t, f=None: T.prefill_logits(p, t, cfg, ctx, frontend=f))
    out[f"{tag}/logits"] = np.asarray(fn(*args))
np.savez(OUT, **out)
"""


def run_prefill_reference(cases, workdir: Path) -> dict:
    n = max(dp * mp for dp, mp in (c["mesh"] for c in cases))
    return run_reference(f"CASES = {cases!r}\n" + PREFILL_REFERENCE, n, workdir)


def prefill_rank(rank, workdir, cases, mesh_shape):
    """One rank of the port's sharded prefill, for each case on this mesh:
    the prefill cell's ``fn`` (the ``seq_parallel`` rule) or, where the
    case sets ``sp``, ``prefill_logits`` with that setting; every attention
    through the flash kernel's op (its plain version on the CPU)."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.launch.mesh import local_block, make_local_mesh
    from repro_torch.launch.specs import build_prefill_cell
    from repro_torch.models import transformer as T

    workdir = Path(workdir)
    ref = dict(np.load(workdir / "reference_out.npz"))
    inp = dict(np.load(workdir / "inputs.npz"))
    mesh = make_local_mesh(*mesh_shape)

    def local(a, spec):
        return torch.from_numpy(np.ascontiguousarray(local_block(a, spec, mesh)))

    out = {}
    for case in cases:
        if tuple(case["mesh"]) != tuple(mesh_shape):
            continue
        tag, cfg = case["tag"], case_config(case)
        params_np = unflatten(ref, f"{tag}/params")
        params = bridge.shard_to_torch(
            params_np, T.param_pspecs(params_np, cfg, mesh.shape["model"]),
            mesh, device="cpu")
        if case.get("sp") is None:
            shape = ShapeConfig("parity", seq_len=case["seq"],
                                global_batch=case["batch"], kind="prefill")
            fn = build_prefill_cell(cfg, shape, mesh,
                                    compute_dtype=torch.float32).fn
        else:
            ctx = T.ParallelCtx(mesh=mesh, remat=False, compute_dtype=torch.float32,
                                seq_parallel=case["sp"])

            def fn(p, t, f=None, cfg=cfg, ctx=ctx):
                return T.prefill_logits(p, t, cfg, ctx, frontend=f,
                                        attention=flash_attention_op)
        args = [params, local(inp[f"{tag}/tokens"], ("data", None)).long()]
        if f"{tag}/frontend" in inp:
            args.append(local(inp[f"{tag}/frontend"], ("data", None, None)))
        out[f"{tag}/logits"] = fn(*args).numpy()
    np.savez(rank_out(workdir, rank), **out)


def run_prefill(cases, workdir: Path):
    """The reference's logits and the port's, put back together: {tag:
    (reference (B, V), port (B, V))}.  One spawn of ranks per mesh."""
    np.savez(workdir / "inputs.npz", **prefill_inputs(cases))
    ref = run_prefill_reference(cases, workdir)
    got = {}
    for mesh_shape in sorted({tuple(c["mesh"]) for c in cases}):
        world = mesh_shape[0] * mesh_shape[1]
        spawn_ranks(prefill_rank, world, str(workdir), cases, mesh_shape)
        port = [dict(np.load(rank_out(workdir, r))) for r in range(world)]
        for case in cases:
            if tuple(case["mesh"]) == mesh_shape:
                tag = case["tag"]
                want = ref[f"{tag}/logits"]
                got[tag] = (want, assemble([p[f"{tag}/logits"] for p in port],
                                           ("data", None), mesh_shape, want.shape))
    return got


# the reference's side of the serve-kinds runs: its make_serve_step on a 2x2
# Auto mesh, f32, from numpy-seeded caches; the step returns only the
# argmax, so the logits it read are captured from ``T.mask_vocab_pad``
SERVE_KINDS_REFERENCE = """
from repro.configs.base import ShapeConfig
from repro.launch import serve_step as SS
from repro.models import transformer as T
from torch_launch_parity import case_config

inp = dict(np.load(IN))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
captured = {}
mask = T.mask_vocab_pad
def capture(logits, cfg):
    captured["logits"] = mask(logits, cfg)
    return captured["logits"]
T.mask_vocab_pad = capture

for ai, case in enumerate(CASES):
    name, cfg = case["tag"], case_config(case, "repro")
    shape = ShapeConfig(**SHAPE)
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",), page=PAGE)
    fn, plan, ctx = SS.make_serve_step(cfg, shape, mesh, plan=plan,
                                       compute_dtype=jnp.float32)
    structs = SS.decode_struct(cfg, shape, mesh, plan, dtype=jnp.float32)[0]
    params = T.init_params(jax.random.PRNGKey(ai), cfg)
    if cfg.xattn_every:          # open the gates of the cross path
        params["segments"] = [dict(s, xgate=jnp.full_like(s["xgate"], 0.5))
                              if "xgate" in s else s for s in params["segments"]]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1 + ai)
    caches = [{k: rng.normal(size=s.shape).astype(np.float32)
               for k, s in c.items()} for c in structs]
    out.update(flatten(params, f"{name}/params"))
    out.update(flatten(caches, f"{name}/caches0"))

    def step_fn(params, caches, step):
        toks, caches = fn(params, caches, step)
        return toks, caches, captured["logits"]
    step_fn = jax.jit(step_fn)
    c = caches
    for t in range(STEPS):
        step = {"tokens": inp[f"{name}/tokens"][t],
                "block_table": inp["block_table"],
                **{k: inp[f"step{t}/{k}"] for k in
                   ("app_slot", "app_off", "app_rank", "lengths")}}
        toks, c, logits = step_fn(params, c, step)
        out[f"{name}/tokens/{t}"] = np.asarray(toks)
        out[f"{name}/logits/{t}"] = np.asarray(logits)
    out.update(flatten(jax.tree.map(np.asarray, c), f"{name}/caches"))
np.savez(OUT, **out)
"""

SERVE_MESH = (2, 2)


def serve_geometry():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(SERVE_MESH, ("data", "model"))
    plan = SS.DecodePlan(batch_axes=("data",), kv_axes=("model",),
                         page=SERVE_PAGE)
    return mesh, plan, ShapeConfig(**SERVE_SHAPE)


def run_serve_kinds(cases, workdir: Path):
    """The reference's serve step and the port's on 4 gloo ranks (2x2) for
    each case: STEPS teacher-forced steps from the same params and caches.
    Returns (reference arrays, per-rank port arrays)."""
    from repro_torch.launch import serve_step as SS
    mesh, plan, shape = serve_geometry()
    geo = SS.cache_geometry(case_config(cases[0]), shape, mesh, plan)
    bt, steps = step_inputs(LENGTHS0, STEPS, dp=geo["dp"], kvr=geo["kvr"],
                            page=plan.page, p_loc=geo["p_loc"],
                            slots=geo["slots_loc"])
    rng = np.random.default_rng(0)
    inputs = {"block_table": bt}
    for t, st in enumerate(steps):
        inputs.update({f"step{t}/{k}": v for k, v in st.items()})
    for case in cases:
        inputs[f"{case['tag']}/tokens"] = rng.integers(
            0, case_config(case).vocab,
            size=(STEPS, shape.global_batch)).astype(np.int32)
    np.savez(workdir / "inputs.npz", **inputs)
    body = (f"CASES = {cases!r}\nSHAPE = {SERVE_SHAPE!r}\nPAGE = {SERVE_PAGE}\n"
            f"STEPS = {STEPS}\n" + SERVE_KINDS_REFERENCE)
    ref = run_reference(body, 4, workdir)
    spawn_ranks(serve_rank, 4, str(workdir), [(c, 0) for c in cases], False)
    return ref, [dict(np.load(rank_out(workdir, r))) for r in range(4)]


# --------------------------------------------------------------------------
# The sharded train step (``test_torch_launch_train*.py``)
# --------------------------------------------------------------------------

TRAIN_MESH = (2, 4)
# (n_micro, global microbatch rows, S); the loss chunk and attention blocks
# of the reduced configs
TRAIN_BATCH = (2, 4, 32)
TRAIN_CTX = dict(q_block=16, kv_block=16, loss_chunk=16)
TRAIN_LR = 1e-3


def train_inputs(cases, seed=0):
    """Per case: tokens and labels (n_micro, mb, S), numpy-seeded, with
    labels of -1 in data rank 0's rows only (so each data rank counts a
    different number of labels)."""
    rng = np.random.default_rng(seed)
    out = {}
    for case in cases:
        cfg = case_config(case)
        toks = rng.integers(0, cfg.vocab, size=TRAIN_BATCH).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, size=TRAIN_BATCH).astype(np.int32)
        rows = TRAIN_BATCH[1] // TRAIN_MESH[0]
        labels[:, :rows, 3:21] = -1
        out[f"{case['tag']}/tokens"], out[f"{case['tag']}/labels"] = toks, labels
    return out


# the reference's side: its make_train_step under jit with make_shardings'
# placements on a 2x4 Auto mesh, f32 compute, one step from init
TRAIN_REFERENCE = """
from repro import optim
from repro.models import transformer as T
from repro.train import trainer
from torch_launch_parity import case_config, TRAIN_CTX, TRAIN_LR

inp = dict(np.load(IN))
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(*MESH), ("data", "model"))
for case in CASES:
    tag, cfg = case["tag"], case_config(case, "repro")
    ctx = T.ParallelCtx(mesh=mesh, dp_axes=("data",), remat=True,
                        compute_dtype=jnp.float32, save_collectives=True,
                        **TRAIN_CTX)
    tcfg = trainer.TrainConfig(
        microbatches=inp[f"{tag}/tokens"].shape[0], zero1=case["zero1"],
        grad_dtype=jnp.bfloat16 if case.get("bf16_grads") else jnp.float32,
        compute_dtype=jnp.float32,
        adamw=optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    params = T.init_params(jax.random.PRNGKey(case.get("seed", 0)), cfg)
    out.update(flatten(jax.tree.map(np.asarray, params), f"{tag}/params0"))
    ins, outs = trainer.make_shardings(cfg, ctx, tcfg, params)
    step = jax.jit(trainer.make_train_step(cfg, ctx, tcfg),
                   in_shardings=ins, out_shardings=outs)
    p, o, m = step(params, optim.init(params), inp[f"{tag}/tokens"],
                   inp[f"{tag}/labels"])
    out.update(flatten(jax.tree.map(np.asarray, p), f"{tag}/params"))
    out.update(flatten(jax.tree.map(np.asarray, o.mu), f"{tag}/mu"))
    out.update(flatten(jax.tree.map(np.asarray, o.nu), f"{tag}/nu"))
    out[f"{tag}/loss"] = np.asarray(m["loss"])
    out[f"{tag}/grad_norm"] = np.asarray(m["grad_norm"])
np.savez(OUT, **out)
"""


def _no_unregistered_autograd():
    """Make torch's warning about a collective without an autograd kernel
    an error (a gradient through it would be silently wrong)."""
    import warnings
    warnings.filterwarnings("error", message=".*autograd kernel was not registered.*")


def train_rank(rank, workdir, cases):
    """One rank of the port's sharded train step for each case: the
    reference's initial params and a fresh AdamW state cut to the rank's
    shards (ZeRO-1 moments where the case says so), its rows of the batch,
    one step.  A case with ``plain_remat`` also takes the step with
    ``save_collectives`` off; the collective calls of each backward are
    counted."""
    import torch
    from repro_torch import bridge, optim
    from repro_torch.launch.mesh import local_block, make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, make_shardings, make_train_step
    _no_unregistered_autograd()
    workdir = Path(workdir)
    ref = dict(np.load(workdir / "reference_out.npz"))
    inp = dict(np.load(workdir / "inputs.npz"))
    mesh = make_local_mesh(*TRAIN_MESH)
    out = {}
    for case in cases:
        tag, cfg = case["tag"], case_config(case)
        tokens, labels = inp[f"{tag}/tokens"], inp[f"{tag}/labels"]
        tcfg = TrainConfig(
            microbatches=tokens.shape[0], zero1=case["zero1"],
            grad_dtype=torch.bfloat16 if case.get("bf16_grads") else torch.float32,
            compute_dtype=torch.float32,
            adamw=optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
        params_np = unflatten(ref, f"{tag}/params0")
        for save in (True, False) if case.get("plain_remat") else (True,):
            ctx = T.ParallelCtx(mesh=mesh, remat=True, compute_dtype=torch.float32,
                                save_collectives=save, **TRAIN_CTX)
            (pspecs, ospecs, batch, _), _ = make_shardings(cfg, ctx, tcfg, params_np)
            params = bridge.shard_to_torch(params_np, pspecs, mesh, device="cpu")
            state = bridge.opt_state_shard_to_torch(
                optim.init(bridge.to_torch(params_np, "cpu")), ospecs.mu, mesh,
                device="cpu")
            local = [torch.from_numpy(np.ascontiguousarray(local_block(a, batch, mesh)))
                     for a in (tokens, labels)]
            step = make_train_step(cfg, ctx, tcfg)
            before = mesh.stats_total("backward")[0]
            p, o, m = step(params, state, *local)
            key = tag if save else f"{tag}/plain"
            out[f"{key}/backward_calls"] = np.asarray(
                mesh.stats_total("backward")[0] - before)
            out.update(flatten(bridge.to_numpy(p), f"{key}/params"))
            out.update(flatten(bridge.to_numpy(o.mu), f"{key}/mu"))
            out.update(flatten(bridge.to_numpy(o.nu), f"{key}/nu"))
            out[f"{key}/loss"] = m["loss"].numpy()
            out[f"{key}/grad_norm"] = m["grad_norm"].numpy()
    np.savez(rank_out(workdir, rank), **out)


def run_train(cases, workdir: Path):
    """The reference's sharded step and the port's on 8 gloo ranks (2x4)
    for each case.  Returns (reference arrays, {key: the port's global
    tree or value}) where key is ``tag`` or ``tag/plain``."""
    from repro_torch import bridge
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, make_shardings
    np.savez(workdir / "inputs.npz", **train_inputs(cases))
    body = f"CASES = {cases!r}\nMESH = {TRAIN_MESH!r}\n" + TRAIN_REFERENCE
    ref = run_reference(body, TRAIN_MESH[0] * TRAIN_MESH[1], workdir)
    world = TRAIN_MESH[0] * TRAIN_MESH[1]
    spawn_ranks(train_rank, world, str(workdir), cases)
    ranks = [dict(np.load(rank_out(workdir, r))) for r in range(world)]
    layout = Mesh(TRAIN_MESH, ("data", "model"))
    got = {}
    for case in cases:
        cfg = case_config(case)
        ctx = T.ParallelCtx(mesh=layout)
        tcfg = TrainConfig(zero1=case["zero1"])
        params_np = unflatten(ref, f"{case['tag']}/params0")
        (pspecs, ospecs, _, _), _ = make_shardings(cfg, ctx, tcfg, params_np)
        for key in (case["tag"], f"{case['tag']}/plain"):
            if f"{key}/loss" not in ranks[0]:
                continue
            res = {name: [r[f"{key}/{name}"] for r in ranks]
                   for name in ("loss", "grad_norm", "backward_calls")}
            for name, specs in (("params", pspecs), ("mu", ospecs.mu),
                                ("nu", ospecs.nu)):
                res[name] = bridge.unshard_to_numpy(
                    [unflatten(r, f"{key}/{name}") for r in ranks], specs, layout)
            got[key] = res
    return ref, got


def check_train_step(runs, tag, rel, abs_tol):
    """One case of ``run_train``: loss and grad norm equal on every rank and
    within ``rel`` of the reference's, params and both moments within
    ``abs_tol``."""
    ref, got = runs
    res = got[tag]
    for name in ("loss", "grad_norm"):
        vals = {float(v) for v in res[name]}
        assert len(vals) == 1, f"{name} differs across ranks: {vals}"
        want = float(ref[f"{tag}/{name}"])
        assert abs(vals.pop() - want) <= rel * abs(want), (name, want)
    for name in ("params", "mu", "nu"):
        want = unflatten(ref, f"{tag}/{name}")
        flat_w, flat_g = flatten(want, name), flatten(res[name], name)
        assert flat_w.keys() == flat_g.keys()
        for key, w in flat_w.items():
            err = float(np.abs(flat_g[key] - w).max())
            assert err <= abs_tol, (key, err)


# --------------------------------------------------------------------------
# The GPipe step (``test_torch_launch_pipeline.py``)
# --------------------------------------------------------------------------

PP_MESH = (2, 1, 2)                  # (pod, data, model)
PP_SHAPE = dict(name="pp", seq_len=32, global_batch=4, kind="train")
PP_MICRO = 2

# the reference's side: its make_pp_train_step's placements and args (no
# jit: jax 0.9's XLA aborts on the step), and its single-device
# make_train_step with the pipeline's semantics (bf16, remat, the same
# microbatches, AdamWConfig()) from the same params
PP_REFERENCE = """
from jax.sharding import PartitionSpec as P
from repro import optim
from repro.configs.base import ShapeConfig
from repro.launch.pipeline import make_pp_train_step
from repro.models import transformer as T
from repro.train import trainer
from torch_launch_parity import case_config

inp = dict(np.load(IN))
out = {}
cfg = case_config(CASE, "repro")
mesh = Mesh(np.array(jax.devices()).reshape(*MESH), ("pod", "data", "model"))
_, args, ins = make_pp_train_step(cfg, ShapeConfig(**SHAPE), mesh, n_micro=MICRO)
# leaves in jax.tree order (the port's tree_flatten order)
out["ins"] = np.array(repr([tuple(s.spec) for s in jax.tree.leaves(
    ins, is_leaf=lambda s: hasattr(s, "spec"))]))
out["args"] = np.array(repr([(tuple(s.shape), str(s.dtype))
                             for s in jax.tree.leaves(args)]))
params = T.init_params(jax.random.PRNGKey(0), cfg)
out.update(flatten(jax.tree.map(np.asarray, params), "params0"))
ctx = T.ParallelCtx(remat=True, compute_dtype=jnp.bfloat16, loss_chunk=256)
tcfg = trainer.TrainConfig(microbatches=MICRO, compute_dtype=jnp.bfloat16)
step = jax.jit(trainer.make_train_step(cfg, ctx, tcfg))
p, o, m = step(params, optim.init(params), inp["tokens"], inp["labels"])
out.update(flatten(jax.tree.map(np.asarray, p), "params"))
out["loss"], out["grad_norm"], out["lr"] = (np.asarray(m[k]) for k in
                                            ("loss", "grad_norm", "lr"))
np.savez(OUT, **out)
"""


def pp_rank(rank, workdir, case):
    """One rank of the port's GPipe step: its stage's shards of the
    reference's params (``pp_specs``), a fresh AdamW state, its rows of
    the batch; one step.  Saves its shards, metrics and hop count."""
    import torch
    from repro_torch import bridge, optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import local_block, make_pod_mesh
    from repro_torch.launch.pipeline import make_pp_train_step
    _no_unregistered_autograd()
    workdir = Path(workdir)
    ref = dict(np.load(workdir / "reference_out.npz"))
    inp = dict(np.load(workdir / "inputs.npz"))
    mesh = make_pod_mesh(*PP_MESH)
    cfg = case_config(case)
    step, _, (specs, _, batch, _) = make_pp_train_step(
        cfg, ShapeConfig(**PP_SHAPE), mesh, n_micro=PP_MICRO)
    params_np = unflatten(ref, "params0")
    params = bridge.shard_to_torch(params_np, specs, mesh, device="cpu")
    state = bridge.opt_state_shard_to_torch(
        optim.init(bridge.to_torch(params_np, "cpu")), specs, mesh, device="cpu")
    local = [torch.from_numpy(np.ascontiguousarray(local_block(inp[k], batch, mesh)))
             for k in ("tokens", "labels")]
    p, _, m = step(params, state, *local)
    out = flatten(bridge.to_numpy(p), "params")
    out.update({k: m[k].numpy() for k in ("loss", "grad_norm", "lr")})
    out["hops"] = np.asarray(sum(v[0] for (d, op), v in mesh.stats.items()
                                 if op == "ring_shift"))
    np.savez(rank_out(workdir, rank), **out)


def run_pipeline(case, workdir: Path):
    """(reference arrays, each rank's arrays) of one GPipe step."""
    cfg = case_config(case)
    rng = np.random.default_rng(3)
    n_micro, b, s = PP_MICRO, PP_SHAPE["global_batch"], PP_SHAPE["seq_len"]
    size = (n_micro, b // n_micro, s)
    np.savez(workdir / "inputs.npz",
             tokens=rng.integers(0, cfg.vocab, size=size).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, size=size).astype(np.int32))
    body = (f"CASE = {case!r}\nMESH = {PP_MESH!r}\nSHAPE = {PP_SHAPE!r}\n"
            f"MICRO = {PP_MICRO}\n" + PP_REFERENCE)
    world = int(np.prod(PP_MESH))
    ref = run_reference(body, world, workdir)
    spawn_ranks(pp_rank, world, str(workdir), case)
    return ref, [dict(np.load(rank_out(workdir, r))) for r in range(world)]


# --------------------------------------------------------------------------
# The dry mesh's transports against a real mesh's
# --------------------------------------------------------------------------

def transport_script(mesh, device):
    """A fixed sequence of transports over ``mesh`` (1x2, data x model):
    all-reduce sum and max, all-gather on the first and the last dim, a
    ring shift, and under autograd ``enter`` and a ring shift whose
    backwards move.  Returns ([(shape, dtype name)] of the outputs,
    {"direction/op": [calls, output bytes]})."""
    import torch
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones((3, 5), dtype=dtype, device=device)
        outs.append(mesh.all_reduce(x.clone(), "model"))
        outs.append(mesh.all_reduce(x.clone(), ("data", "model"), op="max"))
        outs.append(mesh.all_gather(x, "model", dim=0))
        outs.append(mesh.all_gather(x, ("data", "model"), dim=-1))
        outs.append(mesh.ring_shift(x, "model"))
    w = torch.ones((4, 6), device=device, requires_grad=True)
    y = mesh.ring_shift(mesh.enter(w, "model") * 2.0, "model")
    z = mesh.all_gather(y, "model", dim=1)
    outs += [y, z]
    z.sum().backward()
    outs.append(w.grad)
    shapes = [(tuple(o.shape), str(o.dtype)) for o in outs]
    stats = {f"{d}/{op}": [row[0], row[2]] for (d, op), row in mesh.stats.items()}
    return shapes, stats


def transport_rank(rank, workdir):
    import json

    from repro_torch.launch.mesh import Mesh
    shapes, stats = transport_script(Mesh((1, 2), ("data", "model"), rank=rank),
                                     "cpu")
    (Path(workdir) / f"rank{rank}.json").write_text(
        json.dumps({"shapes": shapes, "stats": stats}))
