"""The port's sharded serve step (``launch/serve_step.py``) for the SSM and
hybrid kinds on 4 gloo ranks (2x2: batch over data, TP and pages over
model) against the reference's ``make_serve_step`` on a 2x2 Auto mesh of
fake CPU devices, f32, 8 teacher-forced steps from the same params and
numpy-seeded caches:

* reduced mamba2-2.7b: the SSD state cut on heads (4 a rank);
* reduced hymba-1.5b: SSD heads, paged partials on its global layer and a
  ring on its sliding-window one;
* hymba at d_model 48 with an SSD head_dim of 32: 3 SSD heads do not
  divide model 2, so the state ``ssm_h`` is cut on head_dim while ``wx``'s
  columns come in blocks of 1.5 heads;
* mamba2 with 2 B/C groups: a rank's 4 heads read one group.

Tokens equal at every step; logits and every final cache (``ssm_h``,
``ssm_conv``, pools, rings) within 1e-5, replicas bit-equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

TOL = 1e-5
CASES = [
    dict(tag="mamba2", arch="mamba2-2.7b"),
    dict(tag="hymba", arch="hymba-1.5b"),
    dict(tag="hymba-hd", arch="hymba-1.5b",
         cfg=dict(d_model=48, ssm=dict(head_dim=32))),
    dict(tag="mamba2-g2", arch="mamba2-2.7b", cfg=dict(ssm=dict(n_groups=2))),
]
TAGS = [c["tag"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_serve_kinds(CASES, tmp_path_factory.mktemp("serve_kinds"))


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
            # the step moved every cache it owns (the state decays, rings
            # and pools take appends)
            assert not np.array_equal(w, ref[f"{tag}/caches0/{si}/{key}"]), key


@pytest.mark.parametrize("tag,placement", [
    ("mamba2", (None, "data", "model", None, None)),
    ("hymba-hd", (None, "data", None, "model", None))])
def test_ssm_state_placement(tag, placement):
    from repro_torch.launch import serve_step as SS
    mesh, plan, shape = lp.serve_geometry()
    cfg = lp.case_config(next(c for c in CASES if c["tag"] == tag))
    _, specs, _, _, _ = SS.decode_struct(cfg, shape, mesh, plan)
    assert specs[0]["ssm_h"] == placement
