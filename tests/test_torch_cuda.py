"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card only (the kernels have no CPU mode; without a card these skip).

This file imports neither ``jax`` nor the reference package, so it also runs
on a machine with the card and no JAX, from the repository root:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import device_ops as dev  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import host_pages as hp  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def paged_inputs(b, hq, hkv, d, page, npages, seed=0):
    n_slots = b * npages + 4
    rng = np.random.default_rng(seed)
    bt = np.full((b, npages), -1, np.int32)
    lens = rng.integers(1, npages * page, size=b).astype(np.int32)
    for i in range(b):
        used = int(np.ceil((lens[i] + 1) / page))
        bt[i, :used] = rng.choice(n_slots, used, replace=False)
    if b > 1 and bt[1, 1] >= 0:
        bt[1, 1] = -1                              # a hole mid-sequence
    return (rand(seed, (b, hq, d)), rand(seed + 1, (n_slots, page, hkv, d)),
            rand(seed + 2, (n_slots, page, hkv, d)), bt, lens)


def paged_rows(b, hq, hkv, d, page, n_pages, lens, seed=0):
    """Rows of the given lengths over tables of ``n_pages`` distinct slots;
    every row longer than 40 pages has a -1 page at page 20."""
    rng = np.random.default_rng(seed)
    n_slots = b * n_pages + 4
    bt = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(n_slots)
    for i, n in enumerate(lens):
        used = -(-int(n) // page)
        bt[i, :used] = perm[i * n_pages:i * n_pages + used]
        if used > 40:
            bt[i, 20] = -1
    return (rand(seed, (b, hq, d)), rand(seed + 1, (n_slots, page, hkv, d)),
            rand(seed + 2, (n_slots, page, hkv, d)), bt, np.asarray(lens, np.int32))


def on_card(arrays, cuda, q_dtype, kv_dtype):
    q, kp, vp, bt, lens = arrays
    return (torch.from_numpy(q).to(cuda, TORCH[q_dtype]),
            torch.from_numpy(kp).to(cuda, TORCH[kv_dtype]),
            torch.from_numpy(vp).to(cuda, TORCH[kv_dtype]),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))


PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("bfloat16", "bfloat16")]
_LEN = np.random.default_rng(7)
# (b, hq, hkv, d, page, n_pages, lengths): the split plan gives each case
# the splits named beside it
PAGED_SPLIT_CASES = {
    "granite": (8, 32, 8, 128, 16, 36, _LEN.integers(1, 577, 8)),          # 5
    "gemma3-global": (4, 8, 4, 256, 16, 84, _LEN.integers(1100, 1317, 4)),  # 14
    "hymba-global": (8, 25, 5, 64, 16, 84, _LEN.integers(1100, 1333, 8)),   # 7
    "long": (1, 32, 8, 128, 16, 1024, [16384]),                            # 32
    "some-empty": (3, 8, 2, 64, 16, 128, [2048, 100, 0]),                   # 32
    "single-split": (8, 32, 8, 128, 16, 4, [64, 1, 17, 48, 63, 30, 2, 33]),  # 1
    "page8": (2, 16, 4, 128, 8, 200, [1600, 777]),                          # 25
    "page32": (2, 16, 4, 128, 32, 50, [1600, 31]),                          # 25
    # rows that are not whole 128-byte lines; 16 query heads per KV head
    "g3-d120": (2, 6, 2, 120, 16, 10, [160, 75]),                           # 3
    "g16-d128": (2, 32, 2, 128, 16, 20, [320, 129]),                        # 5
    "g16-d256": (2, 32, 2, 256, 16, 20, [320, 129]),                        # 5
    # one query head per KV head (heads padded to 4 in the kernel): the
    # decode of whisper's dec layers and of deepseek
    "whisper-dec": (8, 20, 20, 64, 16, 28, _LEN.integers(1, 449, 8)),      # 2
    "deepseek": (8, 16, 16, 128, 16, 36, _LEN.integers(1, 545, 8)),        # 3
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,window", [(77, 128, 0), (300, 256, 64),
                                        (5, 16, 0), (130, 120, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kernel_matches_plain(cuda, s, d, window, dtype):
    q = torch.from_numpy(rand(0, (8, s, d))).to(cuda, TORCH[dtype])
    k = torch.from_numpy(rand(1, (2, s, d))).to(cuda, TORCH[dtype])
    v = torch.from_numpy(rand(2, (2, s, d))).to(cuda, TORCH[dtype])
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    assert fa.flash_attention.launches == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,hq,hkv,d", [(40, 333, 8, 2, 128), (77, 77, 4, 4, 64),
                                           (256, 1000, 32, 8, 128), (70, 300, 4, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_non_causal_matches_plain(cuda, sq, sk, hq, hkv, d, dtype):
    """Non-causal launches with Sk != Sq: llama-vision's cross-attention
    over patch tokens, whisper's encoder and its decoder's cross-attention
    over the frames (D 64, G 1)."""
    q = torch.from_numpy(rand(0, (hq, sq, d))).to(cuda, TORCH[dtype])
    k = torch.from_numpy(rand(1, (hkv, sk, d))).to(cuda, TORCH[dtype])
    v = torch.from_numpy(rand(2, (hkv, sk, d))).to(cuda, TORCH[dtype])
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"),
                                              ("bfloat16", "float32"),
                                              ("bfloat16", "bfloat16"),
                                              ("float32", "bfloat16")])
@pytest.mark.parametrize("b,hq,hkv,d,page,npages", [
    (2, 4, 2, 64, 16, 4), (3, 8, 8, 32, 8, 6), (1, 8, 1, 128, 32, 3),
    (4, 32, 8, 128, 16, 40), (2, 8, 4, 256, 4, 20)])
def test_cuda_paged_kernel_matches_plain(cuda, q_dtype, kv_dtype, b, hq, hkv,
                                         d, page, npages):
    q, kp, vp, bt, lens = paged_inputs(b, hq, hkv, d, page, npages)
    args = (torch.from_numpy(q).to(cuda, TORCH[q_dtype]),
            torch.from_numpy(kp).to(cuda, TORCH[kv_dtype]),
            torch.from_numpy(vp).to(cuda, TORCH[kv_dtype]),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))
    got = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    tol = 1e-4 if "bfloat16" not in (q_dtype, kv_dtype) else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS)
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_cuda_paged_split_matches_plain(cuda, case, q_dtype, kv_dtype):
    """The main paths' decode shapes, a long row, many splits of which some
    are empty, a single split, pages of 8 and 32, in all four dtype pairs."""
    b, hq, hkv, d, page, n_pages, lens = PAGED_SPLIT_CASES[case]
    args = on_card(paged_rows(b, hq, hkv, d, page, n_pages, lens), cuda, q_dtype,
                   kv_dtype)
    n = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    assert pa.paged_attention.launches == n + 1
    want = pa.paged_attention_plain(*args)
    tol = 1e-4 if "bfloat16" not in (q_dtype, kv_dtype) else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert got.dtype == TORCH[q_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS)
def test_cuda_paged_rows_are_batch_independent(cuda, q_dtype, kv_dtype):
    """A row's output keeps its bits when the other rows' tables and lengths
    change: the split plan reads shapes only, and each row's sums run in an
    order of their own."""
    b, hq, hkv, d, page, n_pages = 8, 32, 8, 128, 16, 40
    rng = np.random.default_rng(3)
    q, kp, vp, bt, lens = paged_rows(b, hq, hkv, d, page, n_pages,
                                     rng.integers(1, 641, b), seed=3)
    first = pa.paged_attention(*on_card((q, kp, vp, bt, lens), cuda, q_dtype, kv_dtype))
    for trial in range(3):
        bt2, lens2 = bt.copy(), lens.copy()
        lens2[1:] = rng.integers(0, 641, b - 1)
        bt2[1:] = rng.integers(-1, kp.shape[0], (b - 1, n_pages))
        again = pa.paged_attention(*on_card((q, kp, vp, bt2, lens2), cuda, q_dtype,
                                            kv_dtype))
        assert torch.equal(first[0], again[0]), trial


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 8, 1, 16, 16), (2, 64, 4, 16, 2, 8, 32),
    (1, 128, 8, 8, 2, 4, 16), (1, 36, 4, 16, 2, 8, 12),
    (1, 77, 4, 64, 1, 128, 77),          # one ragged chunk, mamba2's P and N
    (2, 512, 6, 64, 2, 16, 256),         # hymba's N, two full chunks
    (1, 130, 3, 128, 1, 128, 65)])       # the largest P and N the kernel takes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rand(0, (b, s, h, p))).to(cuda, TORCH[dtype])
    dt = torch.from_numpy(np.logaddexp(rand(1, (b, s, h)) - 2, 0)
                          .astype(np.float32)).to(cuda)
    A = torch.from_numpy(-np.exp(rng.standard_normal(h)).astype(np.float32)
                         ).to(cuda)
    Bm = torch.from_numpy(rand(2, (b, s, g, n))).to(cuda, TORCH[dtype])
    Cm = torch.from_numpy(rand(3, (b, s, g, n))).to(cuda, TORCH[dtype])
    launches = ssd.ssd_scan.launches
    y, hT = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk)
    assert ssd.ssd_scan.launches == launches + 1
    y_want, h_want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    tol = 3e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y, y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(hT, h_want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("s,window", [(1, 0), (1100, 1024)])
def test_cuda_flash_tensor_core_route_matches_plain(cuda, d, s, window):
    """bf16 q/k/v (the tensor-core route) with a group of 5 query heads per
    KV head, as hymba's 25/5."""
    q = torch.from_numpy(rand(0, (10, s, d))).to(cuda, torch.bfloat16)
    k = torch.from_numpy(rand(1, (2, s, d))).to(cuda, torch.bfloat16)
    v = torch.from_numpy(rand(2, (2, s, d))).to(cuda, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 1024, 4, 64, 1, 128, 256),       # mamba2: N 128, four chunks
    (1, 1536, 5, 64, 1, 16, 256),        # hymba: N 16, six chunks
    (1, 512, 3, 96, 1, 64, 256),         # P 96: the bf16 route's 6-tile variant
    (1, 512, 2, 128, 1, 128, 256)])      # P 128: its 8-tile variant
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_multi_chunk_matches_plain(cuda, b, s, h, p, g, n, chunk,
                                                   dtype):
    test_cuda_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_are_bitwise_repeatable(cuda, dtype):
    """Two calls on the same inputs give the same bits (no atomics, no
    order that depends on scheduling)."""
    td = TORCH[dtype]
    q = torch.from_numpy(rand(0, (10, 300, 64))).to(cuda, td)
    k = torch.from_numpy(rand(1, (2, 300, 64))).to(cuda, td)
    v = torch.from_numpy(rand(2, (2, 300, 64))).to(cuda, td)
    first = fa.flash_attention(q, k, v, causal=True, window=128)
    assert torch.equal(first, fa.flash_attention(q, k, v, causal=True, window=128))

    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 1, 512, 4, 64, 2, 128
    x = torch.from_numpy(rand(3, (b, s, h, p))).to(cuda, td)
    dt = torch.from_numpy(np.logaddexp(rand(4, (b, s, h)) - 2, 0)
                          .astype(np.float32)).to(cuda)
    A = torch.from_numpy(-np.exp(rng.standard_normal(h)).astype(np.float32)
                         ).to(cuda)
    Bm = torch.from_numpy(rand(5, (b, s, g, n))).to(cuda, td)
    Cm = torch.from_numpy(rand(6, (b, s, g, n))).to(cuda, td)
    y1, h1 = ssd.ssd_scan(x, dt, A, Bm, Cm, 256)
    y2, h2 = ssd.ssd_scan(x, dt, A, Bm, Cm, 256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)

    args = [torch.from_numpy(a).to(cuda) for a in paged_inputs(2, 8, 4, 64, 16, 8)]
    args[0], args[1], args[2] = (args[0].to(td), args[1].to(td), args[2].to(td))
    assert torch.equal(pa.paged_attention(*args), pa.paged_attention(*args))
    # many splits and the second (combine) pass
    for case in ("granite", "long", "some-empty"):
        args = on_card(paged_rows(*PAGED_SPLIT_CASES[case]), cuda, dtype, dtype)
        assert torch.equal(pa.paged_attention(*args), pa.paged_attention(*args)), case


def ssd_grad_inputs(cuda, b, s, h, p, g, n, dtype, seed=10):
    rng = np.random.default_rng(seed)
    td = TORCH[dtype]
    return [torch.from_numpy(rand(seed, (b, s, h, p))).to(cuda, td),
            torch.from_numpy(np.logaddexp(rand(seed + 1, (b, s, h)) - 2, 0)
                             .astype(np.float32)).to(cuda),
            torch.from_numpy(-np.exp(rng.standard_normal(h)).astype(np.float32)
                             ).to(cuda),
            torch.from_numpy(rand(seed + 2, (b, s, g, n))).to(cuda, td),
            torch.from_numpy(rand(seed + 3, (b, s, g, n))).to(cuda, td)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 1024, 80, 64, 1, 128, 256),      # mamba2-2.7b's training shape
    (1, 77, 4, 64, 1, 128, 77)])         # one ragged chunk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_gradients_match_plain_autograd(cuda, b, s, h, p, g, n,
                                                      chunk, dtype):
    """On a CUDA tensor under autograd the forward is the kernel (one
    launch, no plain forward) and the gradients of x, dt, A, B and C,
    through ``SSDScan``'s recomputing backward, equal differentiating the
    plain scan on the card (same graph and cotangents: 1e-5 in f32; bf16
    gradients are rounded once to their inputs' dtype: one bf16 step)."""
    kernel_in = [t.requires_grad_() for t in
                 ssd_grad_inputs(cuda, b, s, h, p, g, n, dtype)]
    plain_in = [t.detach().clone().requires_grad_() for t in kernel_in]
    launches = ssd.ssd_scan.launches
    y, h_final = ssd.ssd_scan(*kernel_in, chunk)
    assert ssd.ssd_scan.launches == launches + 1
    assert y.grad_fn is not None
    y_want, h_want = ssd.ssd_scan_plain(*plain_in, chunk)
    tol = 3e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y, y_want, atol=tol, rtol=tol)
    wy = torch.from_numpy(rand(20, tuple(y.shape))).to(cuda)
    wh = torch.from_numpy(rand(21, tuple(h_final.shape))).to(cuda)
    got = torch.autograd.grad((y * wy).sum() + (h_final * wh).sum(), kernel_in)
    want = torch.autograd.grad((y_want * wy).sum() + (h_want * wh).sum(),
                               plain_in)
    assert ssd.ssd_scan.launches == launches + 1    # the backward launches none
    for name, a, w, t in zip("x dt A B C".split(), got, want, kernel_in):
        assert a.dtype == t.dtype, name
        gtol = 1e-5 if a.dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(a, w, atol=gtol * float(w.abs().max()),
                                   rtol=gtol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b", "granite-3-8b"])
def test_cuda_train_step_matches_cpu(cuda, name):
    """One reduced f32 train step (2 microbatches, remat on, S 40 so the SSD
    chunk pads) on the card against the same step on the CPU: loss and grad
    norm within 1e-5, first moments within 1e-4 of each leaf's largest;
    updated params within 1e-3 lr where |g| >= 100 eps and within 2 lr
    below (the step moves an entry by lr g / (|g| + eps), which a rounding
    of a gradient near eps moves by up to lr); the card's SSD scan is the
    kernel."""
    from repro_torch import bridge, optim
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, make_train_step
    cfg = reduced(ARCHS[name])
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ctx = T.ParallelCtx(remat=True, q_block=8, kv_block=8, loss_chunk=8)
    lr = 1e-3
    step = make_train_step(cfg, ctx, TrainConfig(
        microbatches=2, compute_dtype=torch.float32,
        adamw=optim.AdamWConfig(lr=lr, warmup_steps=0)))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 40)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 40)))
    out = []
    launches = ssd.ssd_scan.launches
    for dev in ("cpu", cuda):
        p = bridge.tree_map(lambda t: t.to(dev), params)
        out.append(step(p, optim.init(p), toks.to(dev), labels.to(dev)))
    if cfg.ssm is not None:
        assert ssd.ssd_scan.launches > launches
    (cp, cs, cm), (gp, gs, gm) = out
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[k].cpu(), cm[k], atol=0, rtol=1e-5)
    for a, b, mu in zip(bridge.tree_flatten(cp)[0], bridge.tree_flatten(gp)[0],
                        bridge.tree_flatten(cs.mu)[0]):
        tol = torch.where(mu.abs() / 0.1 >= 1e-6, 1e-3 * lr, 2 * lr)
        assert bool(((b.cpu() - a).abs() <= tol).all())
    for a, b in zip(bridge.tree_flatten(cs.mu)[0], bridge.tree_flatten(gs.mu)[0]):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=1e-4 * float(a.abs().max()) + 1e-30)


# --------------------------------------------------------------------------
# The partial entry: one peer's share of a pool split round-robin over kvr
# --------------------------------------------------------------------------

def split_table(bt, kvr, rank):
    """Rank ``rank``'s local table: page pg of each row is rank pg % kvr's
    local page pg // kvr."""
    local = bt[:, rank::kvr]
    return np.ascontiguousarray(local) if local.size else \
        np.full((bt.shape[0], 1), -1, np.int32)


def partial_args(arrays, cuda, q_dtype, pool, kvr, rank, seed=0):
    """Card tensors of one rank's partial call; an int8 pool gets random
    values and per-(slot, position, head) scales in q's dtype."""
    q, kp, vp, bt, lens = arrays
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dt)
    kw = {}
    if pool == "int8":
        rng = np.random.default_rng(seed)
        kp = rng.integers(-127, 128, size=kp.shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=vp.shape).astype(np.int8)
        kw = {name: t(rng.uniform(1e-3, 3e-2, size=kp.shape[:-1]), TORCH[q_dtype])
              for name in ("k_scale", "v_scale")}
        kp, vp = t(kp, torch.int8), t(vp, torch.int8)
    else:
        kp, vp = t(kp, TORCH[pool]), t(vp, TORCH[pool])
    return (t(q, TORCH[q_dtype]), kp, vp,
            t(split_table(bt, kvr, rank), torch.int32),
            t(lens, torch.int32)), dict(kvr=kvr, rank=rank, **kw)


# the sharded decode's shapes: granite and gemma3's (attn), hymba's global
# layers (G 5), whisper's dec and deepseek's layers (G 1, padded to 4)
PARTIAL_CASES = {k: PAGED_SPLIT_CASES[k] for k in ("granite", "gemma3-global", "some-empty",
                                                   "hymba-global", "whisper-dec", "deepseek")}


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kvr", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_cuda_paged_partials_match_plain(cuda, case, kvr, pool, q_dtype):
    b, hq, hkv, d, page, n_pages, lens = PARTIAL_CASES[case]
    rank = kvr * 5 // 8
    args, kw = partial_args(paged_rows(b, hq, hkv, d, page, n_pages, lens), cuda,
                            q_dtype, pool, kvr, rank)
    n = pa.paged_attention_partials.launches
    got = pa.paged_attention_partials(*args, **kw)
    assert pa.paged_attention_partials.launches == n + 1
    want = pa.paged_attention_partials_plain(*args, **kw)
    tol = 1e-4 if "bfloat16" not in (q_dtype, pool) else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    # a second call gives the same bits
    for g, again in zip(got, pa.paged_attention_partials(*args, **kw)):
        assert torch.equal(g, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvr", [2, 4, 8])
@pytest.mark.parametrize("case", ["granite", "gemma3-global", "hymba-global", "whisper-dec",
                                  "deepseek"])
def test_cuda_paged_partials_combine_to_unsplit_call(cuda, case, kvr, dtype):
    """Every rank's partials, combined over the ranks, are one
    ``paged_attention`` call over the unsplit table."""
    from repro_torch.models.attention import combine_partials
    b, hq, hkv, d, page, n_pages, lens = PAGED_SPLIT_CASES[case]
    arrays = paged_rows(b, hq, hkv, d, page, n_pages, lens)
    parts = []
    for rank in range(kvr):
        args, kw = partial_args(arrays, cuda, dtype, dtype, kvr, rank)
        parts.append(pa.paged_attention_partials(*args, **kw))
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    got = combine_partials((m, l, acc), TORCH[dtype])
    want = pa.paged_attention(*on_card(arrays, cuda, dtype, dtype))
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 512, 40, 64, 1, 128, 256),       # mamba2-2.7b's 80 heads over model 2
    (1, 512, 20, 64, 1, 128, 256),       # ... over model 4
    (1, 512, 25, 64, 1, 16, 256),        # hymba-1.5b's 50 over model 2
    (1, 512, 50, 16, 1, 16, 256)])       # hymba's every head, head_dim 64 / 4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_at_sharded_local_shapes(cuda, b, s, h, p, g, n, chunk,
                                                 dtype):
    """The scan of one rank's part of the SSD state in the sharded prefill:
    its block of heads, or every head's block of head_dim."""
    test_cuda_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n, chunk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d,s,causal,zero", [
    (8, 8, 128, 77, True, 0),        # granite's 32 heads over model 4, K/V repeated
    (8, 8, 128, 130, True, 0),       # deepseek's 16 MHA heads over model 2
    (25, 5, 64, 100, True, 0),       # hymba's attention whole on every rank
    (3, 3, 64, 96, False, 1),        # whisper's 20 heads padded to 24 over 8
    (4, 4, 64, 33, True, 4)])        # a rank holding only padding heads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kernel_at_sharded_local_heads(cuda, hq, hkv, d, s, causal, zero,
                                                  dtype):
    """One rank's heads in the sharded prefill, the last ``zero`` of them
    the zero padding of an MHA arch whose heads do not divide the model
    axis: q, k and v all zero there, and so is the output."""
    q, k, v = (rand(i, (n, s, d)) for i, n in enumerate((hq, hkv, hkv)))
    for t in (q, k, v):
        t[t.shape[0] - zero:] = 0
    q, k, v = (torch.from_numpy(t).to(cuda, TORCH[dtype]) for t in (q, k, v))
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if zero:
        assert torch.count_nonzero(got[hq - zero:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 1024, 40, 64, 1, 128, 256),      # mamba2-2.7b's 80 heads over model 2,
                                         # one row a data rank (chip_smoke 14)
    (2, 1024, 20, 64, 1, 128, 256)])     # ... over model 4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_gradients_at_sharded_train_shapes(cuda, b, s, h, p, g, n,
                                                         chunk, dtype):
    """The scan under autograd at one rank's part of the sharded train
    step: its block of SSD heads."""
    test_cuda_ssd_scan_gradients_match_plain_autograd(cuda, b, s, h, p, g, n,
                                                      chunk, dtype)


# host-tier page moves: (paged layers, page, KV heads, head_dim) of granite's
# and hymba's f32 pools
HOST_GEOMS = {"granite": (40, 16, 8, 128), "hymba": (3, 16, 5, 64)}


def host_pools(name, n_slots, cuda, seed=0):
    layers, page, kv, hd = HOST_GEOMS[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((n_slots, page, kv, hd), device=cuda, generator=g)
            for _ in range(2 * layers)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("granite", 45), ("granite", 140),
                                    ("hymba", 70)])
def test_cuda_host_pages_kernel_matches_plain(cuda, name, n):
    """Gather and scatter bit-exact against the plain version, over more
    pages than one launch takes."""
    pools = host_pools(name, n + 20, cuda)
    rng = np.random.default_rng(n)
    slots = rng.permutation(n + 20)[:n].tolist()
    shape = (n, len(pools)) + tuple(pools[0].shape[1:])
    stage, ref = (torch.empty(shape, device=cuda) for _ in range(2))
    before = hp.host_pages.launches
    hp.host_pages(stage, pools, slots, True)
    assert hp.host_pages.launches - before == -(-n // 64)
    hp.host_pages_plain(ref, pools, slots, True)
    torch.cuda.synchronize()
    assert torch.equal(stage, ref)
    dst = rng.permutation(n + 20)[:n].tolist()
    a, b = [p.clone() for p in pools], [p.clone() for p in pools]
    hp.host_pages(stage, a, dst, False)
    hp.host_pages_plain(stage, b, dst, False)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HOST_GEOMS))
def test_cuda_host_arena_round_trip_is_exact(cuda, name):
    """Pages through pinned arena chunks and a staging buffer smaller than
    the batch come back bit-exactly, with fewer copies than pages."""
    pools = host_pools(name, 96, cuda, seed=1)
    before = [p.clone() for p in pools]
    slot = len(pools) * pools[0][0].nbytes
    arena = dev.HostPageArena()
    arena.STAGE_PAGES, arena.CHUNK_BYTES = 16, 24 * slot
    slots = list(range(5, 55))
    copies = hp.move_pages.copies
    ids = arena.store(pools, slots)
    assert arena.chunks[0].is_pinned() and arena.capacity == 72
    assert hp.move_pages.copies - copies < len(slots)
    for p in pools:
        p.zero_()
    dst = list(range(90, 40, -1))
    arena.load(pools, ids, dst)
    torch.cuda.synchronize()
    for d, s in zip(dst, slots):
        assert all(torch.equal(p[d], q[s]) for p, q in zip(pools, before))
    assert arena.in_use == 0


# the dropless MoE's grouped GEMM: ragged groups (empty, one row, past a
# tile, many tiles), K x N of the cell's gate-up (4096 x 768) and down
# (768 x 4096) products, and small ones
MOE_SIZES = [0, 1, 17, 33, 0, 70, 5, 0]


def moe_inputs(cuda, k, n, sizes, gated, seed=0, t=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    entries = sum(sizes)
    t = t or entries
    a = torch.randn((t, k), device=cuda, generator=g).to(torch.bfloat16)
    w = [(torch.randn((len(sizes), k, n), device=cuda, generator=g) / k ** 0.5)
         .to(torch.bfloat16) for _ in range(2 if gated else 1)]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32,
                           device=cuda)
    rows = torch.randint(0, t, (entries,), device=cuda, generator=g, dtype=torch.int32)
    return a, offsets, w, rows


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(128, 64), (4096, 768), (768, 4096)])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("block_m", [32, 64])
def test_cuda_moe_gemm_matches_plain(cuda, k, n, gated, block_m):
    a, offsets, w, rows = moe_inputs(cuda, k, n, MOE_SIZES, gated, t=50)
    n_rows = sum(MOE_SIZES)
    before = mg.moe_gemm.launches
    got = mg.moe_gemm(a, offsets, *w, rows=rows, n_rows=n_rows + 3, block_m=block_m)
    assert mg.moe_gemm.launches - before == 1
    want = mg.moe_gemm_plain(a, offsets, *w, rows=rows, n_rows=n_rows + 3)
    torch.cuda.synchronize()
    # bf16 outputs of f32 sums taken in another order: a rounding or two
    # of bf16 (2^-8 relative) on values of size ~1
    assert torch.allclose(got[:n_rows].float(), want[:n_rows].float(),
                          atol=2e-2, rtol=2e-2)
    assert torch.isfinite(got[:n_rows].float()).all()
    # again, bit for bit
    assert torch.equal(got[:n_rows], mg.moe_gemm(a, offsets, *w, rows=rows,
                                                 n_rows=n_rows + 3,
                                                 block_m=block_m)[:n_rows])


@pytest.mark.cuda
@pytest.mark.parametrize("block_m", [32, 64])
def test_cuda_moe_gemm_row_keeps_its_bits_in_any_group(cuda, block_m):
    """One row of A gives the same bits alone in its group, at any place in
    a long group, and in the down mode without a row index."""
    a, _, w, _ = moe_inputs(cuda, 256, 128, [1], True, seed=3, t=80)
    one = lambda rows, sizes: mg.moe_gemm(
        a, torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int32, device=cuda),
        w[0].expand(len(sizes), -1, -1).contiguous(),
        w[1].expand(len(sizes), -1, -1).contiguous(),
        rows=torch.tensor(rows, dtype=torch.int32, device=cuda), n_rows=len(rows),
        block_m=block_m)
    alone = one([7], [1])[0]
    others = [r for r in range(80) if r != 7]
    for place in (0, 5, 31, 32, 63, 70):
        rows = others[:place] + [7] + others[place:74]
        got = one(rows, [3, 72])
        assert torch.equal(got[place], alone)


@pytest.mark.cuda
def test_cuda_dropless_moe_matches_cpu_and_counts_its_entries(cuda):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M
    moe = MoEConfig(n_experts=16, top_k=4, n_shared=2, d_expert=128, renorm_topk=True,
                    dropless=True, held_first=4, held_count=8)
    d, t = 256, 96
    p = M.init_moe(d, moe, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    # weights and rows that bf16 holds exactly, so that both devices route
    # the same values
    bf = lambda w: w.to(torch.bfloat16).float()
    p = {k: ({n: bf(w[0]) for n, w in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    p["router"] = p["router"] * 50                 # decisive routing
    x = bf(torch.randn(t, d, generator=torch.Generator().manual_seed(1)))
    active = torch.rand(t, generator=torch.Generator().manual_seed(2)) > 0.25
    want = M.moe_ffn_dropless(p, x, moe, active=active, with_aux=False)
    on = lambda v: v.to(cuda) if v.dtype == torch.bool else v.to(cuda, torch.bfloat16)
    pc = {k: ({n: on(w) for n, w in v.items()} if isinstance(v, dict) else on(v))
          for k, v in p.items()}
    pc["router"] = p["router"].to(cuda)
    counts, before = [], mg.moe_gemm.launches
    with M.tally(counts):
        got = M.moe_ffn_dropless(pc, on(x), moe, active=on(active), with_aux=False)
    assert mg.moe_gemm.launches - before == 2
    torch.cuda.synchronize()
    # bf16 weights and activations against f32: a few bf16 roundings of
    # outputs of size ~0.1
    assert torch.allclose(got.float().cpu(), want, atol=3e-2, rtol=5e-2)
    # the entries computed are those routed to the held experts by active rows
    eids = M.router_topk(pc, on(x), moe)[0]
    mine = (eids >= 4) & (eids < 12) & on(active)[:, None]
    assert int(counts[0].sum()) == int(mine.sum())
    assert torch.equal(counts[0], torch.bincount(eids[mine] - 4, minlength=8))
