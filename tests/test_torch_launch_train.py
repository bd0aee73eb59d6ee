"""The port's sharded train step (``make_train_step`` on a rank mesh with
``make_shardings``' placements) against the reference's under ``jit`` on a
2x4 Auto mesh, 8 gloo ranks, f32, one AdamW step at lr 1e-3 from the same
initial params: reduced granite-3-8b (K/V whole at model 4) with ZeRO-1
on and off and once with bf16 gradient accumulators, and reduced
mamba2-2.7b (each rank scans its 2 of 8 SSD heads) with ZeRO-1 on and
off, and at d_model 48 (the SSD state cut on head_dim).  Labels of -1
fill part of data rank 0's rows only, so the data ranks count different
numbers of labels and the mean must be the global one.

Limits: loss and grad norm within 1e-5 relative; new params and both
moments within 1e-4 absolute (AdamW's eps of 1e-8 turns a 1e-9 gradient
difference into ~0.1 lr on a near-zero gradient).  Replicas must agree bit
for bit.  Also: ``save_collectives`` gives the same bits as plain remat
and moves fewer collectives in the backward."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

REL, ABS = 1e-5, 1e-4
CASES = [
    dict(tag="granite-z1", arch="granite-3-8b", zero1=True, plain_remat=True),
    dict(tag="granite", arch="granite-3-8b", zero1=False),
    dict(tag="granite-bf16", arch="granite-3-8b", zero1=True, bf16_grads=True),
    dict(tag="mamba2-z1", arch="mamba2-2.7b", zero1=True),
    dict(tag="mamba2", arch="mamba2-2.7b", zero1=False),
    # d_model 48: 6 SSD heads do not divide model 4, so each rank scans
    # every head's block of head_dim (dt, A and D enter the rank's part)
    dict(tag="mamba2-hd", arch="mamba2-2.7b", zero1=True, cfg=dict(d_model=48)),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_train(CASES, tmp_path_factory.mktemp("launch_train"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_train_step_matches_reference(runs, tag):
    lp.check_train_step(runs, tag, REL, ABS)


def test_save_collectives_is_bit_identical_and_moves_fewer(runs):
    """The recompute takes the attention's and FFN's collective outputs
    from the tape: the same bits as plain remat, fewer backward calls on
    every rank."""
    _, got = runs
    saved, plain = got["granite-z1"], got["granite-z1/plain"]
    for name in ("loss", "grad_norm"):
        assert all(np.array_equal(a, b) for a, b in zip(saved[name], plain[name]))
    for name in ("params", "mu", "nu"):
        a, b = lp.flatten(saved[name], name), lp.flatten(plain[name], name)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(s < p for s, p in zip(saved["backward_calls"],
                                     plain["backward_calls"]))
