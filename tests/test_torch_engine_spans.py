"""The port's span log (``repro_torch.core.spans``) and the engine's byte
counters, on reduced hymba-1.5b (paged global layers, window rings and SSD
state in every layer) under pool pressure, CPU: the log changes no token
and no ``EngineStats`` field, off it holds nothing, its spans nest, a
pause and its resume read as such, and ``d2h_bytes``/``h2d_bytes`` are the
bytes the pool's and the slots' geometry give for the counted pages and
pauses."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.policies import POLICIES  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ValetServeEngine  # noqa: E402
from torch_parity import CTX, GEOM, assert_same_stats  # noqa: E402

SLOTS = 12          # 6 prompts of 20 tokens, 10 new each: pauses on every run


@pytest.fixture(scope="module")
def model():
    cfg = reduced(ARCHS["hymba-1.5b"])
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=20) for _ in range(6)]
    return cfg, params, prompts


def serve(model, zero, log):
    cfg, params, prompts = model
    eng = ValetServeEngine(params, cfg, CTX, pool_slots=SLOTS,
                           policy=POLICIES["valet"], zero_restore=zero,
                           device="cpu", **GEOM)
    for p in prompts:
        eng.submit(p, max_new=10)
    spans.take()
    if log:
        spans.enable()
    try:
        reqs = eng.run(max_steps=500)
    finally:
        spans.disable()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens_out for r in reqs], eng, spans.take()


@pytest.fixture(scope="module", params=["zero", "legacy"])
def runs(request, model):
    zero = request.param == "zero"
    return serve(model, zero, False), serve(model, zero, True)


def test_log_changes_no_token_and_no_stat(runs):
    (outs_off, eng_off, recs_off), (outs_on, eng_on, recs_on) = runs
    assert outs_on == outs_off
    assert_same_stats(eng_off.stats, eng_on.stats)
    assert eng_on.stats.pauses > 0
    assert recs_off == [] and recs_on


def test_off_log_returns_one_shared_object_and_keeps_nothing():
    assert not spans.enabled()
    a, b = spans.span("engine.step", n=3, step=3), spans.span("x", 7, 9)
    assert a is b
    with a as s:
        s.set(5)
        s.drop()
    assert spans.take() == []


def test_dropped_span_hands_its_children_to_its_parent():
    spans.enable()
    try:
        with spans.span("engine.step", n=4, step=4):
            with spans.span("engine.resume", rid=2) as sp:
                with spans.span("engine.make_room", n=3):
                    pass
                sp.drop()
            with spans.span("engine.decode", n=1) as d:
                d.set(2)
    finally:
        spans.disable()
    recs = spans.take()
    assert [(r.name, r.parent, r.step, r.rid, r.n) for r in recs] == [
        ("engine.step", -1, 4, -1, 4), ("engine.make_room", 0, 4, -1, 3),
        ("engine.decode", 0, 4, -1, 2)]


def test_closed_spans_leave_the_collector_nothing_to_traverse():
    """A long log adds nothing to the cyclic collector's passes: a closed
    span's record holds only a string and integers, and once a collection
    has seen it the collector no longer tracks it."""
    import gc
    spans.enable()
    try:
        for i in range(1000):
            with spans.span("engine.step", n=i, step=i):
                with spans.span("host_tier.issue", n=8):
                    pass
        gc.collect()
        held = list(spans._recs)
    finally:
        spans.disable()
    assert len(held) == 2000 and not any(gc.is_tracked(r) for r in held)
    recs = spans.take()
    assert [r.n for r in recs[::2]] == list(range(1000))
    assert all(r.parent == 2 * i for i, r in enumerate(recs[1::2]))


def test_spans_nest_in_their_parents_and_carry_step_and_rid(runs):
    _, (_, eng, recs) = runs
    steps = [r for r in recs if r.name == "engine.step"]
    assert [r.n for r in steps] == list(range(len(steps)))
    for i, r in enumerate(recs):
        assert r.t0 <= r.t1
        if r.name == "engine.step":
            assert r.parent == -1 and r.step == r.n
            continue
        p = recs[r.parent] if r.parent >= 0 else None
        if p is None:           # run()'s last flush, outside every step
            assert r.step == -1 and r.name.startswith(("engine.flush",
                                                       "host_tier."))
            continue
        assert r.parent < i and p.t0 <= r.t0 and r.t1 <= p.t1
        assert r.step == p.step
        if r.rid >= 0 and p.rid >= 0:
            assert r.rid == p.rid
    parents = {"engine.prefill": "engine.admit",
               "engine.prefill.issue": "engine.prefill",
               "engine.decode": "engine.step",
               "engine.decode.prep": "engine.decode",
               "engine.decode.upload": "engine.decode",
               "engine.decode.issue": "engine.decode",
               "engine.decode.readback": "engine.decode",
               "engine.seq_blob.read": "engine.preempt",
               "engine.repoint": "engine.resume"}
    for r in recs:
        want = parents.get(r.name)
        if want is not None:
            assert recs[r.parent].name == want, r
    for r in recs:
        if r.name in ("engine.admit", "engine.prefill", "engine.resume",
                      "engine.preempt", "engine.seq_blob.read",
                      "engine.seq_blob.write", "engine.repoint",
                      "engine.stream_in"):
            assert 0 <= r.rid < len(eng._requests), r
    names = Counter(r.name for r in recs)
    assert names["engine.admit"] == names["engine.prefill"] == 6
    assert names["engine.prefill.issue"] == 6 + eng.stats.recomputes
    assert names["engine.preempt"] == eng.stats.pauses
    assert names["engine.decode.issue"] == eng.stats.steps
    want = {"engine.make_room", "engine.preempt", "engine.resume"}
    assert want | ({"engine.flush"} if eng._zero else set()) <= set(names)


def test_a_pause_then_its_resume(runs):
    _, (_, eng, recs) = runs
    kids = {}
    for r in recs:
        if r.parent >= 0:
            kids.setdefault(r.parent, []).append(r.name)
    pauses = [i for i, r in enumerate(recs) if r.name == "engine.preempt"]
    assert pauses
    for i in pauses:
        assert kids[i][0] == "engine.seq_blob.read"
        rid = recs[i].rid
        later = [j for j, r in enumerate(recs) if j > i
                 and r.name == "engine.resume" and r.rid == rid]
        assert later, f"request {rid} paused and never resumed"
        j = later[0]
        assert recs[j].step > recs[i].step
        assert {"engine.repoint", "engine.stream_in"} & set(kids[j])
        assert recs[j].n == sum(recs[k].n for k in range(j + 1, len(recs))
                                if recs[k].parent == j
                                and recs[k].name in ("engine.repoint",
                                                     "engine.stream_in"))


def test_byte_counters_follow_the_geometry(runs):
    _, (_, eng, recs) = runs
    st = eng.stats
    page = sum(c["pool"].k[0].nbytes + c["pool"].v[0].nbytes
               for c in eng.batch.caches["layers"] if "pool" in c)
    blob = 0
    for c in eng.batch.caches["layers"]:
        if "ring" in c:
            blob += c["ring"].k[0].nbytes + c["ring"].v[0].nbytes
        if "ssm" in c:
            blob += c["ssm"]["h"][0].nbytes + c["ssm"]["conv"][0].nbytes
    assert page > 0 and blob > 0
    # every pause reads its slot's blob and every resume writes it back
    if eng._zero:
        assert st.d2h_bytes == st.flushed_pages * page + st.pauses * blob
        assert st.h2d_bytes == st.streamed_pages * page + st.pauses * blob
        assert st.streamed_pages > 0 and st.repointed_pages > 0
    else:
        assert st.d2h_bytes == st.spilled_pages * page + st.pauses * blob
        assert st.h2d_bytes == st.restored_pages * page + st.pauses * blob
    # the same bytes read off the spans: ``host_tier.issue`` carries the
    # pages both ways and the blobs to the host, ``engine.seq_blob.write``
    # the blobs back; only the blobs' copies to the host are waited for
    by = Counter()
    for r in recs:
        by[r.name] += r.n
    assert by["host_tier.issue"] + by["engine.seq_blob.write"] \
        == st.d2h_bytes + st.h2d_bytes
    assert by["host_tier.issue"] == st.d2h_bytes + st.h2d_bytes - st.pauses * blob
    assert by["host_tier.wait"] == by["engine.seq_blob.read"] \
        == by["engine.seq_blob.write"] == st.pauses * blob
    assert "host_tier.stack" not in by
