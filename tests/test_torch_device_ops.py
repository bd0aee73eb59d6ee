"""The port's KV-pool data plane against ``repro.core.device_ops``.

Every op runs on the same numpy-seeded inputs in both packages and must be
bit-exact, including the dropped writes (inactive rows, out-of-range slots,
``-1`` prefill slots).  The port writes in place, so "before" snapshots are
taken with ``.clone()``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import device_ops as ref  # noqa: E402
from repro_torch.core import device_ops as dev  # noqa: E402

N_SLOTS, PAGE, N_KV, HD = 8, 4, 2, 16


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def pools(seed=0):
    k = rand(seed, (N_SLOTS, PAGE, N_KV, HD))
    v = rand(seed + 1, (N_SLOTS, PAGE, N_KV, HD))
    return (ref.KVPool(jnp.asarray(k), jnp.asarray(v)),
            dev.KVPool(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def assert_pools_equal(rp, tp):
    np.testing.assert_array_equal(np.asarray(rp.k), tp.k.numpy())
    np.testing.assert_array_equal(np.asarray(rp.v), tp.v.numpy())


def test_make_kv_pool_and_ring_are_zero():
    p = dev.make_kv_pool(N_SLOTS, PAGE, N_KV, HD, torch.float32, device="cpu")
    r = dev.make_ring(3, 5, N_KV, HD, torch.float32, device="cpu")
    assert p.k.shape == (N_SLOTS, PAGE, N_KV, HD) and not p.k.any()
    assert r.v.shape == (3, 5, N_KV, HD) and not r.v.any()


def test_append_token_matches():
    rp, tp = pools()
    k, v = rand(2, (3, N_KV, HD)), rand(3, (3, N_KV, HD))
    slot, off = np.array([5, 0, 7], np.int32), np.array([1, 3, 0], np.int32)
    rp = ref.append_token(rp, jnp.asarray(k), jnp.asarray(v), slot, off)
    out = dev.append_token(tp, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(slot), torch.from_numpy(off))
    assert out.k is tp.k                       # in place
    assert_pools_equal(rp, tp)


@pytest.mark.parametrize("mask", [[True, False, True, True],
                                  [False, False, False, False],
                                  [True, True, True, True]])
def test_append_token_masked_drops_inactive_and_out_of_range(mask):
    rp, tp = pools()
    k, v = rand(4, (4, N_KV, HD)), rand(5, (4, N_KV, HD))
    slot = np.array([2, 6, N_SLOTS + 3, 0], np.int32)   # row 2 out of range
    off = np.array([0, 1, 2, 3], np.int32)
    own = np.array(mask)
    rp = ref.append_token_masked(rp, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(slot), jnp.asarray(off),
                                 jnp.asarray(own))
    dev.append_token_masked(tp, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(slot), torch.from_numpy(off),
                            torch.from_numpy(own))
    assert_pools_equal(rp, tp)


def test_gather_pages_matches():
    rp, tp = pools()
    slots = np.array([[3, 1, -1], [-1, 7, 0]], np.int32)
    rk, rv, rvalid = ref.gather_pages(rp, jnp.asarray(slots))
    tk, tv, tvalid = dev.gather_pages(tp, torch.from_numpy(slots))
    np.testing.assert_array_equal(np.asarray(rk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(rvalid), tvalid.numpy())


def test_write_prefill_pages_skips_minus_one():
    rp, tp = pools()
    kp = rand(6, (2, 3, PAGE, N_KV, HD))
    vp = rand(7, (2, 3, PAGE, N_KV, HD))
    slots = np.array([[4, -1, 2], [-1, 6, 1]], np.int32)
    before = tp.k.clone()
    rp = ref.write_prefill_pages(rp, jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(slots))
    dev.write_prefill_pages(tp, torch.from_numpy(kp), torch.from_numpy(vp),
                            torch.from_numpy(slots))
    assert_pools_equal(rp, tp)
    for s in (0, 3, 5, 7):                     # untouched slots
        assert torch.equal(tp.k[s], before[s])


def test_local_write_batch_and_insert_blocks_match():
    rp, tp = pools()
    kb, vb = rand(8, (3, PAGE, N_KV, HD)), rand(9, (3, PAGE, N_KV, HD))
    slots = np.array([5, 1, 6], np.int32)
    rp = ref.local_write_batch(rp, jnp.asarray(kb), jnp.asarray(vb),
                               jnp.asarray(slots))
    dev.local_write_batch(tp, torch.from_numpy(kb), torch.from_numpy(vb),
                          torch.from_numpy(slots))
    assert_pools_equal(rp, tp)
    rp = ref.insert_blocks(rp, jnp.asarray(vb), jnp.asarray(kb),
                           jnp.asarray(slots[::-1].copy()))
    dev.insert_blocks(tp, torch.from_numpy(vb), torch.from_numpy(kb),
                      torch.from_numpy(slots[::-1].copy()))
    assert_pools_equal(rp, tp)


def test_local_write_batch_round_trip():
    """Bulk page scatter == sequential per-page inserts for distinct slots
    (the port's form of ``test_kernels.py::test_local_write_batch_round_trip``)."""
    pool = dev.make_kv_pool(N_SLOTS, PAGE, N_KV, HD, torch.float32,
                            device="cpu")
    k = torch.from_numpy(rand(3, (3, PAGE, N_KV, HD)))
    v = torch.from_numpy(rand(4, (3, PAGE, N_KV, HD)))
    slots = torch.tensor([5, 1, 6])
    out = dev.local_write_batch(
        dev.KVPool(pool.k.clone(), pool.v.clone()), k, v, slots)
    seq = dev.KVPool(pool.k.clone(), pool.v.clone())
    for i in range(3):
        dev.insert_blocks(seq, k[i:i + 1], v[i:i + 1], slots[i:i + 1])
    assert torch.equal(out.k, seq.k) and torch.equal(out.v, seq.v)
    assert float(out.k[0].abs().sum()) == 0.0  # untouched slots stay zero


def test_stream_page_and_copy_block_match():
    rp, tp = pools()
    kpg, vpg = rand(10, (PAGE, N_KV, HD)), rand(11, (PAGE, N_KV, HD))
    rp = ref.stream_page(rp, kpg, vpg, 3)
    out = dev.stream_page(tp, torch.from_numpy(kpg), torch.from_numpy(vpg), 3)
    assert out.k is tp.k
    assert_pools_equal(rp, tp)
    rp = ref.copy_block(rp, jnp.asarray(3), jnp.asarray(6))
    dev.copy_block(tp, 3, 6)
    assert_pools_equal(rp, tp)


def test_extract_blocks_and_host_tier_round_trip():
    rp, tp = pools()
    slots = np.array([7, 2], np.int32)
    rk, rv = ref.extract_blocks(rp, jnp.asarray(slots))
    tk, tv = dev.extract_blocks(tp, torch.from_numpy(slots))
    np.testing.assert_array_equal(np.asarray(rk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    hk, hv = dev.to_host_tier_many([tk, tv])
    assert hk is not tk and torch.equal(hk, tk)      # a copy on the host
    back = dev.from_host_tier(dev.to_host_tier(tv), like=tp.v)
    assert torch.equal(back, tv) and back.dtype == tp.v.dtype
    np.testing.assert_array_equal(np.asarray(ref.to_host_tier(rk)), hk.numpy())


def test_ring_append_and_valid_match():
    b, w = 2, 5
    rr = ref.make_ring(b, w, N_KV, HD, jnp.float32)
    tr = dev.make_ring(b, w, N_KV, HD, torch.float32, device="cpu")
    for pos in range(7):
        k, v = rand(20 + pos, (b, N_KV, HD)), rand(40 + pos, (b, N_KV, HD))
        rr = ref.ring_append(rr, jnp.asarray(k), jnp.asarray(v), pos)
        dev.ring_append(tr, torch.from_numpy(k), torch.from_numpy(v), pos)
        np.testing.assert_array_equal(np.asarray(rr.k), tr.k.numpy())
        np.testing.assert_array_equal(np.asarray(rr.v), tr.v.numpy())
        np.testing.assert_array_equal(np.asarray(ref.ring_valid(rr, pos)),
                                      dev.ring_valid(tr, pos).numpy())
