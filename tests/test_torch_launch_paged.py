"""The port's sharded paged-attention inner (``launch/serve_step.py``
``_paged_attn_sharded``) on 8 gloo ranks (a 2x4 data x model mesh) against
the reference's on a 2x4 Auto mesh of fake CPU devices, with the inputs of
``tests/test_sharding.py``'s decode check:

* f32 pools: output within 1e-5, updated pools bit-equal;
* int8 pools (per-(slot, position, head) scales): quantised values and
  scales bit-equal, output within 1e-5 of the reference's int8 output;

and, in one process, the paged kernel's partial entry (its plain version
on the CPU) against the reference's ``decode_partial`` over pages gathered
by hand at their absolute positions.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
BQ, HQ, HKV, D, PAGE, P_LOC, SLOTS = 4, 4, 2, 16, 4, 3, 8
DP, KVR = lp.PAGED_MESH
LENGTHS = (37, 30, 21, 14)

REFERENCE = """
from repro.launch.serve_step import _paged_attn_sharded, DecodePlan, _quantize_token

inp = dict(np.load(IN))
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
args = [jnp.asarray(inp[k]) for k in ("bt", "q", "k", "v", "app_slot",
                                       "app_off", "app_rank", "lengths")]
out = {}
pk, pv = inp["pool_k"], inp["pool_v"]
qk, sk, qv, sv = [np.zeros(s, d) for s, d in (
    (pk.shape, np.int8), (pk.shape[:-1], np.float32),
    (pk.shape, np.int8), (pk.shape[:-1], np.float32))]
for di in range(pk.shape[0]):
    for r in range(pk.shape[1]):
        for s in range(pk.shape[2]):
            a, b = _quantize_token(jnp.asarray(pk[di, r, s]))
            qk[di, r, s], sk[di, r, s] = np.asarray(a), np.asarray(b)
            a, b = _quantize_token(jnp.asarray(pv[di, r, s]))
            qv[di, r, s], sv[di, r, s] = np.asarray(a), np.asarray(b)
caches = {"bf16": {"pool_k": pk, "pool_v": pv},
          "int8": {"pool_k": qk, "pool_v": qv, "scale_k": sk, "scale_v": sv}}
for kv_dtype, cache in caches.items():
    plan = DecodePlan(batch_axes=("data",), kv_axes=("model",), page=4,
                      kv_dtype=kv_dtype)
    for k, a in cache.items():
        out[f"{kv_dtype}/in/{k}"] = a
    upd, o = jax.jit(lambda c, *a: _paged_attn_sharded(
        c, *a, mesh=mesh, plan=plan, page=4, out_dtype=jnp.float32))(
        {k: jnp.asarray(a) for k, a in cache.items()}, *args)
    out[f"{kv_dtype}/out"] = np.asarray(o)
    for k, a in upd.items():
        out[f"{kv_dtype}/{k}"] = np.asarray(a)
np.savez(OUT, **out)
"""


def sharding_inputs():
    """``tests/test_sharding.py``'s decode inputs: pools, q/k/v, lengths,
    and block tables with page pg of sequence b on KV rank pg % kvr."""
    rng = np.random.default_rng(0)
    pool_k = rng.normal(size=(DP, KVR, SLOTS, PAGE, HKV, D)).astype(np.float32)
    pool_v = rng.normal(size=(DP, KVR, SLOTS, PAGE, HKV, D)).astype(np.float32)
    q = rng.normal(size=(BQ, HQ, D)).astype(np.float32)
    k = rng.normal(size=(BQ, HKV, D)).astype(np.float32)
    v = rng.normal(size=(BQ, HKV, D)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    bt = np.full((DP, KVR, BQ // DP, P_LOC), -1, np.int32)
    app = {k: np.zeros(BQ, np.int32) for k in ("app_rank", "app_slot", "app_off")}
    for b in range(BQ):
        for pg in range(int(lengths[b]) // PAGE + 1):
            r, j = pg % KVR, pg // KVR
            bt[b // (BQ // DP), r, b % (BQ // DP), j] = (b + pg) % SLOTS
        cur = int(lengths[b])
        pgc = cur // PAGE
        app["app_rank"][b] = pgc % KVR
        app["app_slot"][b] = (b + pgc) % SLOTS
        app["app_off"][b] = cur % PAGE
    return dict(pool_k=pool_k, pool_v=pool_v, q=q, k=k, v=v, lengths=lengths,
                bt=bt, **app)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("launch_paged")
    np.savez(wd / "inputs.npz", **sharding_inputs())
    ref = lp.run_reference(REFERENCE, DP * KVR, wd)
    lp.spawn_ranks(lp.paged_rank, DP * KVR, str(wd))
    port = [dict(np.load(lp.rank_out(wd, r))) for r in range(DP * KVR)]
    return ref, port


def _global(port, key, spec, shape):
    return lp.assemble([p[key] for p in port], spec, lp.PAGED_MESH, shape)


POOL = ("data", "model", None, None, None, None)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sharded_output_within_tolerance(runs, kv_dtype):
    """The float pool (the plan's "bf16", here f32 arrays) and the int8
    pool, each against the reference's output for the same pool."""
    ref, port = runs
    want = ref[f"{kv_dtype}/out"]
    got = _global(port, f"{kv_dtype}/out", ("data", None, None), want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


@pytest.mark.parametrize("key", ["pool_k", "pool_v"])
def test_sharded_append_bit_equal(runs, key):
    ref, port = runs
    want = ref[f"bf16/{key}"]
    np.testing.assert_array_equal(_global(port, f"bf16/{key}", POOL, want.shape),
                                  want)
    assert not np.array_equal(want, ref[f"bf16/in/{key}"])


@pytest.mark.parametrize("key", ["pool_k", "pool_v", "scale_k", "scale_v"])
def test_int8_values_and_scales_equal(runs, key):
    ref, port = runs
    want = ref[f"int8/{key}"]
    spec = POOL if key.startswith("pool") else POOL[:-1]
    got = _global(port, f"int8/{key}", spec, want.shape)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, ref[f"int8/in/{key}"])


# --------------------------------------------------------------------------
# The partial entry's plain version against decode_partial, one process
# --------------------------------------------------------------------------

def _by_hand(q, pool_k, pool_v, bt, lengths, kvr, rank, scales):
    """The reference's decode_partial over one rank's pages, gathered one
    page at a time, each token at its absolute position."""
    import jax.numpy as jnp
    from repro.models.attention import decode_partial
    ms, ls, accs = [], [], []
    for b in range(q.shape[0]):
        keys, vals, valid = [], [], []
        for j, slot in enumerate(bt[b]):
            kp, vp = pool_k[max(slot, 0)], pool_v[max(slot, 0)]
            if scales is not None:
                kp = kp.astype(np.float32) * scales[0][max(slot, 0)][..., None]
                vp = vp.astype(np.float32) * scales[1][max(slot, 0)][..., None]
            keys.append(kp)
            vals.append(vp)
            pos = (j * kvr + rank) * PAGE + np.arange(PAGE)
            valid.append((pos < lengths[b]) & (slot >= 0))
        m, l, a = decode_partial(jnp.asarray(q[b:b + 1]),
                                 jnp.asarray(np.concatenate(keys))[None],
                                 jnp.asarray(np.concatenate(vals))[None],
                                 jnp.asarray(np.concatenate(valid))[None])
        ms.append(m[0])
        ls.append(l[0])
        accs.append(a[0])
    return [np.stack(x) for x in (ms, ls, accs)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kvr,rank", [(1, 0), (2, 0), (2, 1), (4, 1), (4, 3)])
def test_plain_partial_matches_decode_partial(kvr, rank, quant):
    from repro_torch.kernels.paged_attention import paged_attention_partials
    rng = np.random.default_rng(7 + kvr + rank)
    b, slots, p_loc = 5, 24, 4
    q = rng.normal(size=(b, HQ, D)).astype(np.float32)
    if quant:
        pool_k = rng.integers(-127, 128, size=(slots, PAGE, HKV, D)).astype(np.int8)
        pool_v = rng.integers(-127, 128, size=(slots, PAGE, HKV, D)).astype(np.int8)
        scales = [rng.uniform(1e-3, 2e-2, size=(slots, PAGE, HKV)).astype(np.float32)
                  for _ in range(2)]
    else:
        pool_k = rng.normal(size=(slots, PAGE, HKV, D)).astype(np.float32)
        pool_v = rng.normal(size=(slots, PAGE, HKV, D)).astype(np.float32)
        scales = None
    bt = rng.permutation(slots)[:b * p_loc].reshape(b, p_loc).astype(np.int32)
    bt[1, 2:] = -1                       # a hole and a short table
    bt[3, 1] = -1
    # lengths from 0 (no token) past what the rank's pages hold
    lengths = np.asarray([0, 9, 23, 40, 64], np.int32)
    kw = {} if scales is None else dict(k_scale=torch.from_numpy(scales[0]),
                                        v_scale=torch.from_numpy(scales[1]))
    m, l, acc = paged_attention_partials(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(bt), torch.from_numpy(lengths), kvr=kvr, rank=rank, **kw)
    want = _by_hand(q, pool_k, pool_v, bt, lengths, kvr, rank, scales)
    for got, w in zip((m, l, acc), want):
        assert got.dtype == torch.float32
        err = float(np.abs(got.numpy() - w).max())
        assert err <= TOL, err


def test_partials_of_one_rank_combine_to_paged_attention():
    """At kvr 1 the combined partial is ``paged_attention``'s output."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_partials)
    from repro_torch.models.attention import combine_partials
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, HQ, D)).astype(np.float32))
    pk = torch.from_numpy(rng.normal(size=(10, PAGE, HKV, D)).astype(np.float32))
    pv = torch.from_numpy(rng.normal(size=(10, PAGE, HKV, D)).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(10)[:9].reshape(3, 3).astype(np.int32))
    lengths = torch.tensor([5, 12, 1], dtype=torch.int32)
    m, l, acc = paged_attention_partials(q, pk, pv, bt, lengths)
    out = combine_partials((m[None], l[None], acc[None]), torch.float32)
    torch.testing.assert_close(out, paged_attention(q, pk, pv, bt, lengths),
                               rtol=0, atol=TOL)


def test_out_of_range_append_is_dropped_as_the_reference():
    """An owned append whose slot is out of range is dropped (the
    reference's ``mode="drop"``), on a 1x1 mesh in this process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from repro.launch import serve_step as ref_SS
    from repro_torch.launch import serve_step as SS
    from repro_torch.launch.mesh import Mesh
    rng = np.random.default_rng(5)
    pools = {k: rng.normal(size=(1, 1, SLOTS, PAGE, HKV, D)).astype(np.float32)
             for k in ("pool_k", "pool_v")}
    bt = np.asarray([[[[0, 1], [2, -1]]]], np.int32)
    q = rng.normal(size=(2, HQ, D)).astype(np.float32)
    k = rng.normal(size=(2, HKV, D)).astype(np.float32)
    v = rng.normal(size=(2, HKV, D)).astype(np.float32)
    step = [np.asarray(a, np.int32) for a in ([SLOTS + 3, 2], [1, 2], [0, 0], [5, 2])]
    ref_mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref_plan = ref_SS.DecodePlan(("data",), ("model",), page=PAGE)
    upd, want = jax.jit(lambda c, *a: ref_SS._paged_attn_sharded(
        c, *a, mesh=ref_mesh, plan=ref_plan, page=PAGE, out_dtype=jnp.float32))(
        pools, bt, q, k, v, *step)
    cache = {key: torch.from_numpy(a.copy()) for key, a in pools.items()}
    got = SS._paged_attn_sharded(
        cache, torch.from_numpy(bt), *(torch.from_numpy(a) for a in (q, k, v, *step)),
        mesh=Mesh((1, 1), ("data", "model"), rank=0),
        plan=SS.DecodePlan(("data",), ("model",), page=PAGE), out_dtype=torch.float32)
    for key in pools:
        np.testing.assert_array_equal(cache[key].numpy(), np.asarray(upd[key]))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL
