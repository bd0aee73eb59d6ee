"""The sample that the check serves again, and the loops and families
found by name."""
import sys
import types

import pytest

from valetbench import loops, reference
from valetbench.harness import check
from valetbench.harness.drive import ReqRec, Served
from valetbench.harness.weights import leaf_shapes
from valetbench.harness.work import Model
from vbtiny import tiny_config

SPEC = {"sample": {"tokens": 100, "requests": 8, "resumed": 2}}


def served(reqs):
    return Served([], {r.rid: r for r in reqs}, {}, (0.0, 1.0))


def req(rid, max_new, served=None, pauses=0, resume_at=None, share=0.0, prompt=10,
        done=True):
    """A request that served ``served`` tokens (all of them when done)."""
    n = max_new if done else served
    return ReqRec(rid, rid, prompt, max_new, token_times=[0.1] * n, pauses=pauses,
                  resume_at=resume_at, repoint_share=share,
                  done_t=0.5 if done else None)


def test_sample_takes_the_longest_then_finished_paused_ones_first():
    reqs = [req(0, 60, prompt=500), req(1, 60), req(2, 60, pauses=1),
            req(3, 60), req(4, 60)]
    for seed in (1, 2, 2 ** 33 + 5):
        got = check.sample(served(reqs), dict(SPEC, sample=dict(SPEC["sample"],
                                                                resumed=0)), seed)
        assert got[:2] == [0, 2] and len(got) == 2          # 120 tokens >= 100
        assert check.sample(served(reqs), SPEC, seed)[:2] == got


def test_sample_adds_resumed_requests_finished_or_not_repointed_first():
    reqs = [req(0, 90, prompt=500), req(1, 60),
            req(2, 200, served=30, pauses=1, resume_at=10, share=0.0, done=False),
            req(3, 200, served=30, pauses=2, resume_at=12, share=1.5, done=False),
            req(4, 200, served=9, pauses=1, resume_at=9, share=9.0, done=False),
            req(5, 200, served=5, pauses=1, done=False),            # not resumed
            req(6, 200, served=40, done=False)]
    for seed in (1, 2, 2 ** 33 + 5):
        got = check.sample(served(reqs), SPEC, seed)
        assert got[0] == 0 and set(got[1:-2]) <= {1}
        # 4 served nothing since its resume; 3 has the larger repoint share
        assert got[-2:] == [3, 2]


def test_sample_counts_resumed_requests_it_already_holds():
    reqs = [req(0, 90, prompt=500), req(1, 60, pauses=1, resume_at=20),
            req(2, 200, served=30, pauses=1, resume_at=10, done=False),
            req(3, 200, served=30, pauses=1, resume_at=10, done=False)]
    got = check.sample(served(reqs), SPEC, 7)
    assert got[:2] == [0, 1] and len(got) == 3 and got[2] in (2, 3)


def test_verdict_wants_every_token_of_a_finished_request_only():
    reqs = {0: req(0, 4), 1: req(1, 9, served=3, pauses=1, resume_at=1, done=False)}
    objs = {0: types.SimpleNamespace(tokens_out=[1, 2, 3, 4]),
            1: types.SimpleNamespace(tokens_out=[1, 2, 3])}
    limits = {"max_logit_gap": {"limit": 0.5}}
    assert check.verdict(objs, reqs, [0, 1], {0: 0.1, 1: 0.2}, limits)[:2] == (True, 0)
    assert check.verdict(objs, reqs, [0, 1], {0: 0.1, 1: 0.6}, limits)[:2] == (False, 1)
    objs[0].tokens_out = [1, 2, 3]
    assert check.verdict(objs, reqs, [0, 1], {0: 0.1, 1: 0.2}, limits)[:2] == (False, 1)


def test_loops_are_found_by_the_traffic_kind():
    assert callable(loops.of({"kind": "closed"}).serve)
    with pytest.raises(ModuleNotFoundError):
        loops.of({"kind": "no_such_loop"})


def test_a_family_is_laid_out_and_counted_by_its_reference_module(monkeypatch):
    """A family without attention (an MLP stack) needs only its module."""
    fam = types.ModuleType("valetbench.reference.mlp_only")

    def run_leaves(config, run, prefix):
        n, d = run["count"], config["hidden_size"]
        return [(prefix + ("w",), "w", (n, d, d), "bf16")]

    def layer_work(config, run):
        return {"matmul": config["hidden_size"] ** 2, "attn": None,
                "token_flops": 7.0, "ssd": None}
    fam.run_leaves, fam.layer_work = run_leaves, layer_work
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    cfg = dict(tiny_config("granite-3-8b"), reference="mlp_only",
               layers=[{"kind": "mlp", "count": 3, "window": 0}])
    assert reference.of(cfg) is fam
    assert [lf[2] for lf in leaf_shapes(cfg)[3:]] == [(3, 64, 64)]
    m = Model(cfg)
    assert m.paged_layers == 0 and m.windows == []
    assert m.token_flops(99) == 2.0 * 3 * 64 * 64 + 3 * 7.0
    assert m.flash_bound([40]) == 0.0 and m.paged_bound([5], 16) == 0.0


@pytest.mark.parametrize("name, kind", [("granite-3-8b", "hybrid"), ("hymba-1.5b", "attn")])
def test_a_family_refuses_a_layer_kind_it_does_not_have(name, kind):
    cfg = tiny_config(name)
    cfg["layers"] = [dict(run, kind=kind) for run in cfg["layers"]]
    with pytest.raises(ValueError):
        leaf_shapes(cfg)
    with pytest.raises(ValueError):
        Model(cfg)
