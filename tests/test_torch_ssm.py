"""The port's SSD scan and Mamba-2 block against the JAX reference (CPU):
the kernel's plain version against the Pallas ``ssd_scan`` (interpret
mode) on the ``test_kernels.py`` shapes and a ragged chunk, ``ssd_chunked``
with a carried-in state, ``ssm_forward`` with its decode state and
``ssm_decode_step`` (f32, 1e-5), the exactness of the chunk padding, and
the wrapper's input checks.  The CUDA kernel itself is held against the
plain version in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced, replace  # noqa: E402
from repro.kernels import ref as ref_lib  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.configs import replace as t_replace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SCAN_TOL = 3e-4        # the tolerance of tests/test_kernels.py's SSD sweep
TOL = 1e-5


def scan_inputs(b, s, h, p, g, n, seed=0):
    """x, dt (post-softplus), A < 0, B, C as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def torch_of(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 8, 1, 16, 16),
    (2, 64, 4, 16, 2, 8, 32),
    (1, 128, 8, 8, 2, 4, 16),
    (1, 36, 4, 16, 2, 8, 12),          # ragged: a chunk of 12 steps
])
def test_ssd_plain_matches_pallas(b, s, h, p, g, n, chunk):
    inputs = scan_inputs(b, s, h, p, g, n)
    y_want, h_want = pallas_ssd(*map(jnp.asarray, inputs), chunk,
                                interpret=True)
    y, hT = ssd.ssd_scan(*torch_of(*inputs), chunk)
    assert y.dtype == hT.dtype == torch.float32
    close(y_want, y, SCAN_TOL)
    close(h_want, hT, SCAN_TOL)
    y_op, h_op = ops.ssd_scan_op(*torch_of(*inputs), chunk=chunk)
    assert torch.equal(y, y_op) and torch.equal(hT, h_op)
    # the oracles agree too
    y_r, h_r = ref_lib.ssd_scan_ref(*map(jnp.asarray, inputs), chunk)
    y_t, h_t = t_ref.ssd_scan_ref(*torch_of(*inputs), chunk)
    close(y_r, y_t)
    close(h_r, h_t)


def test_ssd_plain_takes_bf16_inputs():
    """bf16 x/B/C (the compute dtype) are widened to f32, as the reference
    does; y and the state come out in f32."""
    x, dt, A, Bm, Cm = scan_inputs(1, 32, 2, 8, 1, 16)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, Bm, Cm)]
    y_want, h_want = ref_lib.ssd_scan_ref(bf[0], jnp.asarray(dt),
                                          jnp.asarray(A), bf[1], bf[2], 16)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm)]
    y, hT = ssd.ssd_scan(tb[0], torch.from_numpy(dt), torch.from_numpy(A),
                         tb[1], tb[2], 16)
    assert y.dtype == hT.dtype == torch.float32
    close(y_want, y, SCAN_TOL)
    close(h_want, hT, SCAN_TOL)


def test_ssd_chunked_with_h0_matches_reference():
    x, dt, A, Bm, Cm = scan_inputs(2, 24, 4, 8, 2, 8, seed=1)
    rng = np.random.default_rng(2)
    D = rng.standard_normal(4).astype(np.float32)
    h0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    y_want, h_want = ref_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, D)), 8, h0=jnp.asarray(h0))
    y, hT = ssm.ssd_chunked(*torch_of(x, dt, A, Bm, Cm, D), 8,
                            h0=torch.from_numpy(h0))
    close(y_want, y)
    close(h_want, hT)


@pytest.mark.parametrize("s", [12, 8])
def test_chunk_padding_is_exact(s):
    """Padded steps carry dt = 0: they neither add to nor decay the state.
    S = 12 scanned in chunks of 4 equals the same steps padded to 16 and
    scanned in chunks of 8, in both packages (and S = 8, which needs no
    padding, for the same comparison with chunks of 4 and 8)."""
    x, dt, A, Bm, Cm = scan_inputs(1, s, 2, 8, 1, 8, seed=3)
    pad = (-s) % 8
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, Bm, Cm)]
    D = np.ones(2, np.float32)
    for lib, arr in ((ref_ssm, jnp.asarray), (ssm, torch.from_numpy)):
        y4, h4 = lib.ssd_chunked(*map(arr, (x, dt, A, Bm, Cm, D)), 4)
        xp, dtp, Bp, Cp = padded
        y8, h8 = lib.ssd_chunked(*map(arr, (xp, dtp, A, Bp, Cp, D)), 8)
        np.testing.assert_allclose(np.asarray(h8), np.asarray(h4),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(np.asarray(y8)[:, :s], np.asarray(y4),
                                   atol=TOL, rtol=TOL)


def ssm_setup(seed=0, chunk_size=None):
    """Reference SSM params of reduced mamba2 (as numpy) and the configs."""
    cfg = reduced(ARCHS["mamba2-2.7b"])
    tcfg = t_reduced(T_ARCHS["mamba2-2.7b"])
    if chunk_size is not None:
        cfg = replace(cfg, ssm=replace(cfg.ssm, chunk_size=chunk_size))
        tcfg = t_replace(tcfg, ssm=t_replace(tcfg.ssm, chunk_size=chunk_size))
    params = ref_ssm.init_ssm(ref_layers.KeyGen(jax.random.PRNGKey(seed)),
                              cfg.d_model, cfg.ssm)
    # nonzero conv bias and gate norm, so every parameter is exercised
    params = dict(params)
    rng = np.random.default_rng(seed + 10)
    for k in ("conv_b", "gate_norm"):
        params[k] = jnp.asarray(
            0.1 * rng.standard_normal(params[k].shape).astype(np.float32))
    np_params = jax.tree.map(np.asarray, params)
    return cfg, tcfg, np_params, bridge.to_torch(np_params, "cpu")


@pytest.mark.parametrize("s", [13, 16, 3])
def test_ssm_forward_with_state_matches_reference(s):
    cfg, tcfg, params, tparams = ssm_setup()
    x = np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    out_want, st_want = ref_ssm.ssm_forward(params, jnp.asarray(x),
                                            cfg.d_model, cfg.ssm,
                                            return_state=True)
    out, st = ssm.ssm_forward(tparams, torch.from_numpy(x), tcfg.d_model,
                              tcfg.ssm, return_state=True)
    close(out_want, out)
    close(st_want["h"], st["h"])
    close(st_want["conv"], st["conv"])
    assert st["h"].dtype == torch.float32
    close(ref_ssm.ssm_forward(params, jnp.asarray(x), cfg.d_model, cfg.ssm),
          ssm.ssm_forward(tparams, torch.from_numpy(x), tcfg.d_model,
                          tcfg.ssm))


def test_ssm_forward_state_does_not_depend_on_the_chunk():
    """The decode state after a 12-token prompt is the same whether the
    scan runs unpadded in chunks of 4 or padded to 16 in chunks of 8."""
    x = np.random.default_rng(5).standard_normal((1, 12, 64)).astype(
        np.float32)
    states = []
    for chunk in (4, 8):
        _, tcfg, _, tparams = ssm_setup(chunk_size=chunk)
        _, st = ssm.ssm_forward(tparams, torch.from_numpy(x), tcfg.d_model,
                                tcfg.ssm, return_state=True)
        states.append(st)
    torch.testing.assert_close(states[0]["h"], states[1]["h"], atol=TOL,
                               rtol=TOL)
    assert torch.equal(states[0]["conv"], states[1]["conv"])


def test_ssm_decode_step_matches_reference():
    cfg, tcfg, params, tparams = ssm_setup(seed=1)
    rng = np.random.default_rng(6)
    st = ref_ssm.ssm_init_state(3, cfg.d_model, cfg.ssm)
    tst = ssm.ssm_init_state(3, tcfg.d_model, tcfg.ssm, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in st.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tst.items()}
    for _ in range(4):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        y_want, st = ref_ssm.ssm_decode_step(params, jnp.asarray(x), st,
                                             cfg.d_model, cfg.ssm)
        y, tst = ssm.ssm_decode_step(tparams, torch.from_numpy(x), tst,
                                     tcfg.d_model, tcfg.ssm)
        close(y_want, y)
        close(st["h"], tst["h"])
        close(st["conv"], tst["conv"])


def test_decode_continues_the_forward_state():
    """Prefill state + one decode step gives the forward's next output."""
    _, tcfg, _, tparams = ssm_setup(seed=2)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 10, 64)).astype(np.float32))
    full = ssm.ssm_forward(tparams, x, tcfg.d_model, tcfg.ssm)
    _, st = ssm.ssm_forward(tparams, x[:, :9], tcfg.d_model, tcfg.ssm,
                            return_state=True)
    y, _ = ssm.ssm_decode_step(tparams, x[:, 9], st, tcfg.d_model, tcfg.ssm)
    torch.testing.assert_close(y, full[:, 9], atol=1e-4, rtol=1e-4)


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = torch_of(*scan_inputs(1, 32, 4, 8, 2, 8))
    with pytest.raises(ValueError):                     # chunk must divide S
        ssd.ssd_scan(x, dt, A, Bm, Cm, 12)
    with pytest.raises(ValueError):                     # chunk <= 256
        ssd.ssd_scan(x, dt, A, Bm, Cm, 512)
    with pytest.raises(TypeError):                      # dt must be f32
        ssd.ssd_scan(x, dt.double(), A, Bm, Cm, 16)
    with pytest.raises(TypeError):                      # B/C in x's dtype
        ssd.ssd_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, 16)
    with pytest.raises(TypeError):                      # f32 or bf16 only
        ssd.ssd_scan(x.double(), dt, A, Bm.double(), Cm.double(), 16)
    with pytest.raises(ValueError):                     # contiguous inputs
        ssd.ssd_scan(x.transpose(2, 3), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError):                     # H % G == 0
        ssd.ssd_scan(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(),
                     A[:3].contiguous(), Bm, Cm, 16)
    wide = torch.zeros((1, 16, 1, 160))                 # N > 128
    with pytest.raises(ValueError):
        ssd.ssd_scan(torch.zeros((1, 16, 1, 8)), torch.zeros((1, 16, 1)),
                     torch.zeros((1,)), wide, wide, 16)
