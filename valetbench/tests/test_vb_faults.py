"""The check against a broken timed path: the rest of a run as the
benchmark makes it (on the CPU, at a reduced size), with the port broken
underneath, must come out not correct.  The faults a serving cell on one
chip can have: a decode step that leaves the KV pool unchanged, half of
each row's context left out of its attention, and a token altered where
it is produced.  (There is no exchange between chips on one chip.)  The
control, the reference in fp8, must fail the same limit."""
import pytest
import torch

from repro_torch.core import device_ops
from repro_torch.models import decode
from vbtiny import TINY_LIMIT, rehearse, tiny_cell

CELLS = ["granite-3-8b.chat.pressure", "hymba-1.5b.long.pressure"]


def state_unchanged(monkeypatch):
    monkeypatch.setattr(device_ops, "append_token_masked",
                        lambda pool, *a, **k: pool)


def half_context(monkeypatch):
    real = decode.paged_attention_op
    monkeypatch.setattr(decode, "paged_attention_op",
                        lambda q, k, v, bt, lengths: real(q, k, v, bt, (lengths + 1) // 2))


def token_altered(monkeypatch):
    real = decode.decode_step

    def step(*a, **k):
        logits, caches = real(*a, **k)
        logits = logits.clone()
        logits[:, 7] = logits.max() + 1.0
        return logits, caches
    monkeypatch.setattr(decode, "decode_step", step)


@pytest.mark.parametrize("fault", [state_unchanged, half_context, token_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = rehearse(tiny_cell(workload))
    assert out["correct"] is False
    assert out["checked"]["max_logit_gap"]["value"] > TINY_LIMIT


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_path_is_correct_and_the_fp8_control_is_not(workload):
    reads = [rehearse(tiny_cell(workload, width=128, vocab=2000), seed=s,
                      control=True)["control"] for s in (101, 202, 303)]
    served = max(max(r["served_gap"].values()) for r in reads)
    control = max(max(r["control_gap"].values()) for r in reads)
    assert served <= TINY_LIMIT < control
    # the control through the harness's own comparison with the limit
    for r in reads:
        assert r["checked"]["max_logit_gap"]["limit"] == TINY_LIMIT
        assert r["correct"] is (max(r["control_gap"].values()) <= TINY_LIMIT)
    assert not all(r["correct"] for r in reads)


def test_the_broken_kv_really_reaches_the_pool(monkeypatch):
    pool = device_ops.make_kv_pool(4, 2, 1, 8, torch.float32, device="cpu")
    state_unchanged(monkeypatch)
    k = torch.ones(1, 1, 8)
    out = device_ops.append_token_masked(pool, k, k, torch.tensor([0]), torch.tensor([0]),
                                         torch.tensor([True]))
    assert float(out.k.abs().sum()) == 0.0
