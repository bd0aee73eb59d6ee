"""The flash kernel's plain version against the Pallas flash kernel
(interpret mode) on the ``test_kernels.py`` sweep: MHA, GQA, MQA, head_dim
96, f32 and bf16, causal / windowed / bidirectional."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(x, dtype):
    return jnp.asarray(x).astype(JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 256, 4, 1, 128),     # MQA
    (2, 128, 2, 2, 96),      # odd head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_pallas(b, s, hq, hkv, d, dtype, causal, window):
    qj, qt = both(rand(0, (b * hq, s, d)), dtype)
    kj, kt = both(rand(1, (b * hkv, s, d)), dtype)
    vj, vt = both(rand(2, (b * hkv, s, d)), dtype)
    want = pallas_flash(qj, kj, vj, causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype
    close(want, got, dtype)


def close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])
