"""The paged kernel's split arithmetic on the CPU: for the plan that
``split_plan`` gives, each split's partial softmax (``decode_partial`` over
its run of tokens) combined by ``combine_partials`` -- what the two passes of
``csrc/paged_attention.cu`` compute -- against the Pallas kernel in interpret
mode on the same numpy inputs; and the plan itself, which reads static
shapes only."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.attention import combine_partials, decode_partial  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N_TOK = 192                       # tokens of a row at every page size
LENGTHS = [128, 1, 150, 192]      # a split boundary, length 1, a hole, full


def split_attention(q, k_pool, v_pool, block_table, lengths, run, n_splits):
    """The kernel's two passes in plain PyTorch: ``decode_partial`` over each
    split's run of tokens, then ``combine_partials`` over the stack."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    p = block_table.shape[1]
    bt = block_table.long()
    keys = k_pool[bt.clamp(min=0)].reshape(b, p * page, hkv, d)
    values = v_pool[bt.clamp(min=0)].reshape(b, p * page, hkv, d)
    pos = torch.arange(p * page)[None, :]
    valid = (pos < lengths.long()[:, None]) & \
        (bt >= 0).repeat_interleave(page, dim=1)
    parts = [decode_partial(q, keys[:, s * run:(s + 1) * run],
                            values[:, s * run:(s + 1) * run],
                            valid[:, s * run:(s + 1) * run])
             for s in range(n_splits)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return combine_partials((m, l, acc), q.dtype)


def split_inputs(hq, hkv, d, page, seed=0):
    """Four rows of ``LENGTHS`` over N_TOK / page pages each; row 2 has a -1
    page in the middle of its second run (the page of token 88)."""
    rng = np.random.default_rng(seed)
    b, n_pages = len(LENGTHS), N_TOK // page
    n_slots = b * n_pages + 3
    bt = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(n_slots)
    for i, n in enumerate(LENGTHS):
        used = -(-n // page)
        bt[i, :used] = perm[i * n_pages:i * n_pages + used]
    bt[2, 88 // page] = -1
    lens = np.asarray(LENGTHS, np.int32)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((n_slots, page, hkv, d)).astype(np.float32),
            rng.standard_normal((n_slots, page, hkv, d)).astype(np.float32),
            bt, lens)


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 2), (10, 2)])   # G 1, 2, 4, 5
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_combine_matches_pallas(page, hq, hkv, dtype):
    d = 32
    q, kp, vp, bt, lens = split_inputs(hq, hkv, d, page)
    run, n_splits = pa.split_plan(len(LENGTHS), hkv, hq // hkv, d, page,
                                  bt.shape[1], TORCH[dtype], TORCH[dtype])
    # three runs of 64 tokens: 128 ends on a boundary, row 1's last two
    # runs are empty, row 2's hole lies inside its second run
    assert (run, n_splits) == (64, 3)
    want = pallas_paged(*(jnp.asarray(x).astype(JNP[dtype]) for x in (q, kp, vp)),
                        jnp.asarray(bt), jnp.asarray(lens), interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(TORCH[dtype]) for x in (q, kp, vp))
    got = split_attention(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(lens),
                          run, n_splits)
    assert got.dtype == TORCH[dtype] and got.shape == (len(LENGTHS), hq, d)
    np.testing.assert_allclose(np.asarray(want, np.float32), got.float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_split_plan_reads_static_shapes_only():
    """The plan takes shapes and dtypes, never lengths or table contents: the
    same plan whatever a batch holds, and every shape of the main paths
    fills more than one wave of the card's SMs."""
    assert list(inspect.signature(pa.split_plan).parameters) == [
        "b", "hkv", "g", "d", "page", "n_pages", "q_dtype", "kv_dtype"]
    rng = np.random.default_rng(0)
    q, kp, _, bt, _ = split_inputs(8, 2, 32, 16)
    plan = pa.plan_for(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(bt))
    for _ in range(5):
        other = rng.integers(-1, kp.shape[0], size=bt.shape).astype(np.int32)
        assert pa.plan_for(torch.from_numpy(q), torch.from_numpy(kp),
                           torch.from_numpy(other)) == plan
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, Hkv, G, D, page, P): granite, gemma3 global, hymba global decode;
    # one long sequence
    for shape, want in [((8, 8, 4, 128, 16, 36), (128, 5)),
                        ((4, 4, 2, 256, 16, 84), (96, 14)),
                        ((8, 5, 5, 64, 16, 84), (192, 7)),
                        ((1, 8, 4, 128, 16, 1024), (512, 32))]:
        run, n_splits = pa.split_plan(*shape, bf16, f32)
        assert (run, n_splits) == want
        b, hkv, _, d, page, p = shape
        assert run % pa.tile_tokens(d, f32) == 0 and run % page == 0
        assert (n_splits - 1) * run < p * page <= n_splits * run
        assert b * hkv * n_splits > pa.SMS


def test_split_plan_units():
    """Runs are whole pages and whole tiles, within the kernel's limits."""
    bf16 = torch.bfloat16
    for page in (1, 2, 4, 8, 16, 32, 64, 96, 128, 160, 256):
        for b, hkv, p, d in ((1, 1, 3, 64), (2, 4, 7, 128), (8, 8, 40, 256), (1, 8, 4096, 8)):
            run, n_splits = pa.split_plan(b, hkv, 4, d, page, p, bf16, bf16)
            assert run % pa.tile_tokens(d, bf16) == 0 and run % page == 0
            assert run <= max(pa.MAX_RUN, page)
            assert (n_splits - 1) * run < p * page <= n_splits * run
    with pytest.raises(ValueError):
        pa.split_plan(1, 1, 1, 64, 12, 4, bf16, bf16)
