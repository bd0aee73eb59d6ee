"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card only (the kernels have no CPU mode; without a card these skip).

This file imports neither ``jax`` nor the reference package, so it also runs
on a machine with the card and no JAX, from the repository root:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

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
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"),
                                              ("bfloat16", "float32"),
                                              ("bfloat16", "bfloat16")])
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
