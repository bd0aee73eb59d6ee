"""The port's sharded serve step against the reference's (see
``test_torch_launch_serve_kinds.py``) for the cross-attention kinds and
the MoE FFN, on 4 gloo ranks (2x2), f32, 8 teacher-forced steps:

* reduced llama-3.2-vision-11b (gates opened): ``xattn`` layers over the
  replicated cross K/V;
* reduced whisper-large-v3: ``dec`` layers, paged self-attention then
  cross-attention, GELU FFN;
* reduced deepseek-moe-16b: EP over model 2 (8 experts a rank), one row a
  token per step, and a dense first layer.

Tokens equal at every step; logits and every final cache within 1e-5,
replicas bit-equal; the cross K/V are read, never written."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="llama-vision", arch="llama-3.2-vision-11b"),
    dict(tag="whisper", arch="whisper-large-v3"),
    dict(tag="deepseek", arch="deepseek-moe-16b"),
]
TAGS = [c["tag"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_serve_kinds(CASES, tmp_path_factory.mktemp("serve_kinds_cross"))


def _global(port, key, spec, shape):
    return lp.assemble([p[key] for p in port], spec, lp.SERVE_MESH, shape)


@pytest.mark.parametrize("step", range(lp.STEPS))
@pytest.mark.parametrize("tag", TAGS)
def test_tokens_equal_every_step(runs, tag, step):
    ref, port = runs
    want = ref[f"{tag}/tokens/{step}"]
    got = _global(port, f"{tag}/tokens/{step}", ("data",), want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tag", TAGS)
def test_logits_within_tolerance(runs, tag):
    ref, port = runs
    for step in range(lp.STEPS):
        want = ref[f"{tag}/logits/{step}"]
        got = _global(port, f"{tag}/logits/{step}", ("data", None), want.shape)
        assert np.isfinite(got).all()
        err = float(np.abs(got - want).max())
        assert err <= TOL, (step, err)


@pytest.mark.parametrize("tag", TAGS)
def test_caches_within_tolerance(runs, tag):
    from repro_torch.launch import serve_step as SS
    ref, port = runs
    mesh, plan, shape = lp.serve_geometry()
    cfg = lp.case_config(next(c for c in CASES if c["tag"] == tag))
    _, specs, _, _, _ = SS.decode_struct(cfg, shape, mesh, plan)
    want = lp.unflatten(ref, f"{tag}/caches")
    assert len(want) == len(specs)
    for si, (c, sp) in enumerate(zip(want, specs)):
        assert set(c) == set(sp)
        for key, w in c.items():
            got = _global(port, f"{tag}/caches/{si}/{key}", sp[key], w.shape)
            err = float(np.abs(got - w).max())
            assert err <= TOL, (si, key, err)
            before = ref[f"{tag}/caches0/{si}/{key}"]
            if key.startswith("cross"):
                np.testing.assert_array_equal(got, before)
            else:
                assert not np.array_equal(w, before), key
