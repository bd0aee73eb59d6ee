"""Kernel wrappers of the port: the paged plain version against the Pallas
kernel (interpret mode) on the shapes of ``test_kernels.py``, ragged
prefill lengths against the JAX oracle, input checks, and — on a CUDA card
only — the hand-written kernels against their plain versions.  The flash
sweep against Pallas is in ``test_torch_kernels_flash.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_lib  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(JNP[dtype])
    t = torch.from_numpy(x).to(TORCH[dtype])
    return j, t


def close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("s", [5, 77])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_op_ragged_lengths_match_oracle(s, causal, window):
    """Prefill prompts are not tile multiples: the op takes any S."""
    q, k, v = rand(3, (1, s, 4, 16)), rand(4, (1, s, 2, 16)), rand(5, (1, s, 2, 16))
    want = ref_lib.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
    got = ops.flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window)
    close(want, got, "float32")
    close(want, t_ref.flash_attention_ref(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(v), causal=causal,
                                          window=window), "float32")


def paged_inputs(b, hq, hkv, d, page, npages, seed=0):
    n_slots = b * npages + 4
    rng = np.random.default_rng(seed)
    bt = np.full((b, npages), -1, np.int32)
    lens = rng.integers(1, npages * page, size=b).astype(np.int32)
    for i in range(b):
        used = int(np.ceil((lens[i] + 1) / page))
        bt[i, :used] = rng.choice(n_slots, used, replace=False)
    return (rand(seed, (b, hq, d)), rand(seed + 1, (n_slots, page, hkv, d)),
            rand(seed + 2, (n_slots, page, hkv, d)), bt, lens)


@pytest.mark.parametrize("b,hq,hkv,d,page,npages", [
    (2, 4, 2, 64, 16, 4),
    (3, 8, 8, 32, 8, 6),
    (1, 8, 1, 128, 32, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas(b, hq, hkv, d, page, npages, dtype):
    q, kp, vp, bt, lens = paged_inputs(b, hq, hkv, d, page, npages)
    qj, qt = both(q, dtype)
    kj, kt = both(kp, dtype)
    vj, vt = both(vp, dtype)
    want = pallas_paged(qj, kj, vj, jnp.asarray(bt), jnp.asarray(lens),
                        interpret=True)
    got = pa.paged_attention(qt, kt, vt, torch.from_numpy(bt),
                             torch.from_numpy(lens))
    close(want, got, dtype)
    got_op = ops.paged_attention_op(qt, kt, vt, torch.from_numpy(bt),
                                    torch.from_numpy(lens))
    assert torch.equal(got, got_op)
    # the oracles agree too
    close(ref_lib.paged_attention_ref(qj, kj, vj, jnp.asarray(bt),
                                      jnp.asarray(lens)),
          t_ref.paged_attention_ref(qt, kt, vt, torch.from_numpy(bt),
                                    torch.from_numpy(lens)), dtype)


def test_paged_skips_invalid_pages():
    """-1 block-table entries contribute nothing (Valet GPT miss -> pad)."""
    kp, vp = rand(1, (8, 8, 1, 16)), rand(2, (8, 8, 1, 16))
    q = torch.from_numpy(rand(0, (1, 2, 16)))
    lens = torch.tensor([15], dtype=torch.int32)
    a = pa.paged_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.tensor([[0, 1, -1, -1]], dtype=torch.int32),
                           lens)
    b = pa.paged_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.tensor([[0, 1]], dtype=torch.int32), lens)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_wrappers_raise_on_what_the_kernel_does_not_take():
    q, kp, vp, bt, lens = paged_inputs(2, 4, 2, 64, 16, 4)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens)]
    with pytest.raises(TypeError):
        pa.paged_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError):
        pa.paged_attention(args[0][:, :, :60].contiguous(), *args[1:])
    with pytest.raises(ValueError):           # page must divide 64
        pa.paged_attention(args[0], args[1][:, :12].contiguous(),
                           args[2][:, :12].contiguous(), *args[3:])
    x = torch.zeros((4, 8, 12))                # head_dim not a multiple of 8
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        fa.flash_attention(x.double(), x.double(), x.double())
