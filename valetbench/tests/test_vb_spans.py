"""The readers of the port's span log on synthetic runs, the idle gaps put
down to program spans, the arming through ``STEPS``, and the clock that
program spans share with the profiler."""
import sys
import time

import numpy as np
import pytest

from repro_torch.core import spans
from repro_torch.core.spans import Span
from valetbench.harness import spanlog
from valetbench.harness.drive import Served, StepRec
from valetbench.harness.runner import metric_module, trace_steps
from valetbench.harness.runview import Run
from valetbench.harness.spec import HERE
from valetbench.harness.trace import HARNESS, STEP, TraceData, Tracer
from valetbench.harness.work import Model
from vbtiny import tiny_cell

sys.path.insert(0, str(HERE))

MS = 1_000_000      # ns
READERS = ("resume_ms_p95", "orchestration_host_share", "host_copy_gb_per_ktok",
           "decode_issue_ms_p50")


def step(i, phase, tokens=0):
    counts = {"tokens": tokens, "pauses": 0, "restored_pages": 0,
              "streamed_pages": 0, "repointed_pages": 0, "recomputes": 0,
              "flushed_pages": 0}
    return StepRec(i, float(i), float(i + 1), counts, [], [], phase)


def make_run(window=(1.0, 3.0)):
    cell = tiny_cell("granite-3-8b.chat.pressure")
    steps = [step(0, "warmup", 5), step(1, "window", 400), step(2, "window", 600),
             step(3, "after", 7)]
    served = Served(steps, {}, {}, window)
    return Run(cell, served, Model(cell.config), 1.0)


def rec(name, t0, t1, parent=-1, step=1, rid=-1, n=0):
    return Span(name, t0 * MS, t1 * MS, parent, step, rid, n)


def spans_of_three_steps():
    """Steps 0 (warm-up), 1 and 2 (the window); in ms from 0."""
    out = []
    for s, base in ((0, 0), (1, 1000), (2, 2000)):
        top = len(out)
        out.append(rec("engine.step", base, base + 900, -1, s, n=s))
        res = len(out)
        out.append(rec("engine.resume", base + 10, base + 110, top, s, rid=s, n=4))
        mr = len(out)
        out.append(rec("engine.make_room", base + 10, base + 60, res, s, n=4))
        out.append(rec("engine.preempt", base + 10, base + 30, mr, s, rid=9))
        out.append(rec("engine.flush", base + 30, base + 60, mr, s, n=4))
        out.append(rec("host_tier.issue", base + 30, base + 40, len(out) - 1, s,
                       n=(s + 1) * 10**9))
        out.append(rec("engine.stream_in", base + 60, base + 110, res, s, rid=s))
        out.append(rec("host_tier.stack", base + 70, base + 90, len(out) - 1, s,
                       n=2 * 10**9))
        out.append(rec("engine.flush", base + 120, base + 150, top, s))
        dec = len(out)
        out.append(rec("engine.decode", base + 200, base + 900, top, s))
        out.append(rec("engine.decode.issue", base + 300, base + 300 + 10 * (s + 1),
                       dec, s))
    out.append(rec("engine.seq_blob.write", 2400, 2401, 0, 2, rid=1, n=5 * 10**8))
    out.append(rec("engine.step", 3000, 3900, -1, 3, n=3))
    return out


def steps_only():
    """The log of a run that did nothing but step: one ``engine.step``
    for each of ``make_run``'s four steps."""
    return [rec("engine.step", 1000 * s, 1000 * s + 900, -1, s, n=s)
            for s in range(4)]


@pytest.fixture
def logged(monkeypatch):
    recs = spans_of_three_steps()
    monkeypatch.setattr(spanlog, "records", lambda: recs)
    monkeypatch.setattr(spanlog, "_owner", None)
    return recs


def read(name, run):
    return metric_module(name).read(run)


def test_readers_read_the_window_steps_only(logged):
    run = make_run()
    # resumes of steps 1 and 2: 100 ms each
    assert read("resume_ms_p95", run) == pytest.approx(100.0)
    # per window step: [10, 110] and [120, 150]: 130 ms, twice, over 2 s
    assert read("orchestration_host_share", run) == pytest.approx(13.0)
    # (2e9 + 2e9) + (3e9 + 2e9) + 0.5e9 bytes over 1000 tokens
    assert read("host_copy_gb_per_ktok", run) == pytest.approx(9.5)
    # issues of 20 and 30 ms
    assert read("decode_issue_ms_p50", run) == pytest.approx(25.0)


def test_readers_read_none_without_the_log_or_the_work(monkeypatch):
    run = make_run()
    monkeypatch.setattr(spanlog, "_owner", None)
    monkeypatch.setattr(spanlog, "records", lambda: None)
    for name in READERS:
        assert read(name, run) is None
    monkeypatch.setattr(spanlog, "records", steps_only)
    assert read("resume_ms_p95", run) is None
    assert read("decode_issue_ms_p50", run) is None
    assert read("orchestration_host_share", run) == 0.0
    assert read("host_copy_gb_per_ktok", run) == 0.0
    monkeypatch.setattr(spanlog, "records", spans_of_three_steps)
    monkeypatch.setattr(spanlog, "_owner", None)
    run.served.steps[1].counts["tokens"] = run.served.steps[2].counts["tokens"] = 0
    assert read("host_copy_gb_per_ktok", run) is None


def test_readers_read_only_their_own_runs_records(monkeypatch):
    """Records that are not one ``engine.step`` per step of the run (a
    log armed late, or another run's) read None, and so do the records
    another run has claimed: stale records are never read."""
    monkeypatch.setattr(spanlog, "_owner", None)
    monkeypatch.setattr(spanlog, "records", lambda: steps_only()[1:])
    run = make_run()
    assert read("orchestration_host_share", run) is None
    recs = steps_only() + steps_only()          # two runs without an arm
    monkeypatch.setattr(spanlog, "records", lambda: recs)
    assert read("orchestration_host_share", run) is None
    recs = spans_of_three_steps()
    monkeypatch.setattr(spanlog, "records", lambda: recs)
    assert read("orchestration_host_share", run) == pytest.approx(13.0)
    later = make_run()                          # as many steps, not armed again
    for name in READERS:
        assert read(name, later) is None
    assert read("resume_ms_p95", run) == pytest.approx(100.0)


def test_union_counts_nested_spans_once():
    recs = [rec("a", 0, 10), rec("b", 2, 4), rec("c", 8, 15), rec("d", 20, 21)]
    assert spanlog.union_s(recs) == pytest.approx(0.016)
    assert spanlog.union_s([]) == 0


def test_steps_arms_the_log_for_traced_runs_only(monkeypatch):
    monkeypatch.setattr(spanlog, "_armed", False)
    monkeypatch.setattr(spanlog, "_taken", None)
    monkeypatch.setattr(spanlog, "_owner", None)
    try:
        # what runner.run_cell asks before a traced run's warm-up on a card
        assert trace_steps(tiny_cell("granite-3-8b.chat.pressure")) == 12
        assert spans.enabled()
        with spans.span("engine.resume", 3, 2, step=5):
            pass
    finally:
        spans.disable()
    got = spanlog.records()
    assert [(r.name, r.step, r.rid, r.n) for r in got] == [("engine.resume", 5, 3, 2)]
    assert not spans.enabled() and spanlog.records() is got


def trace_of(gaps_in, steps, harness=()):
    """A trace whose device is busy everywhere in the window but in
    ``gaps_in`` (s)."""
    lo = min(a for a, _ in steps)
    hi = max(b for _, b in steps + list(harness))
    ops, t = [], lo
    for a, b in sorted(gaps_in):
        if a > t:
            ops.append(("k", t, a))
        t = b
    if hi > t:
        ops.append(("k", t, hi))
    spans_ = [(STEP, a, b) for a, b in steps] + [(HARNESS, a, b) for a, b in harness]
    return TraceData(ops, sorted(spans_, key=lambda s: s[1]), (lo, hi))


def test_idle_goes_to_the_innermost_program_span():
    # vb.step 0-1 s, vb.harness 1-1.1 s, vb.step 1.1-2 s; gaps (s):
    # 0.05-0.1 before any program span, 0.3-0.4 in engine.flush ->
    # host_tier.wait, 0.5-0.6 in engine.flush outside its children,
    # 1.02-1.05 in the harness, 1.5-1.6 in the second step's decode upload
    trace = trace_of([(0.05, 0.1), (0.3, 0.4), (0.5, 0.6), (1.02, 1.05), (1.5, 1.6)],
                     [(0.0, 1.0), (1.1, 2.0)], harness=[(1.0, 1.1)])
    recs = [rec("engine.step", 100, 990, -1, 0),
            rec("engine.flush", 200, 700, 0, 0),
            rec("host_tier.issue", 250, 290, 1, 0),
            rec("host_tier.wait", 290, 450, 1, 0),
            rec("engine.step", 1100, 1990, -1, 1),
            rec("engine.decode", 1400, 1900, 4, 1),
            rec("engine.decode.upload", 1450, 1650, 5, 1)]
    labels = ["step: 3 decodes, pauses", "step: 3 decodes"]
    old = trace.idle_by_label(labels)
    new = spanlog.idle_by_span(trace, labels, recs)
    assert new == pytest.approx({"step: 3 decodes, pauses": 0.05, "host_tier.wait": 0.1,
                                 "engine.flush": 0.1, "engine.decode.upload": 0.1,
                                 "harness: bookkeeping and submit": 0.03})
    assert sum(new.values()) == pytest.approx(sum(old.values()))
    assert sum(old.values()) == pytest.approx(0.38)


def test_idle_without_records_is_todays():
    trace = trace_of([(0.2, 0.3), (1.5, 1.55)], [(0.0, 1.0), (1.1, 2.0)],
                     harness=[(1.0, 1.1)])
    labels = ["step: 1 decodes", "step: 2 decodes"]
    assert spanlog.idle_by_span(trace, labels, []) == trace.idle_by_label(labels)
    assert spanlog.idle_by_span(trace, labels, None) == trace.idle_by_label(labels)


def test_program_spans_share_the_profilers_clock():
    """A ``record_function`` label and a program span around one 20 ms
    sleep, under the profiler as ``Tracer`` runs it, start and end within
    1 ms of each other.  (A process's first label takes ~1 ms to set up
    between its start and its body, so one label runs first.)"""
    import torch
    spans.take()
    with Tracer(cuda=torch.cuda.is_available()) as scope:
        scope.start()
        with scope.harness():
            pass
        spans.enable()
        try:
            with scope.step(), spans.span("engine.step", n=0, step=0):
                time.sleep(0.02)
        finally:
            spans.disable()
    (r,) = spans.take()
    (name, a, b) = scope.data.spans[-1]
    assert name == STEP and b - a >= 0.02
    assert abs(r.t0 * 1e-9 - a) < 1e-3 and abs(r.t1 * 1e-9 - b) < 1e-3
    assert np.isclose((r.t1 - r.t0) * 1e-9, b - a, atol=1e-3)


def test_span_report_rehearses_on_the_cpu(monkeypatch):
    """``spanreport.py``'s run at a CPU test's size: ``run_cell``'s own
    run and check, the engine's spans read, the log's cost priced."""
    from spanreport import report
    from valetbench.harness import runner
    monkeypatch.setattr(spanlog, "_armed", False)     # restored after the test
    monkeypatch.setattr(spanlog, "_taken", None)
    monkeypatch.setattr(spanlog, "_owner", None)
    out = report(tiny_cell("hymba-1.5b.long.pressure"), 2 ** 31 + 11, 1.5, "cpu",
                 time.perf_counter(), log=lambda *a: None)
    assert not spans.enabled() and runner.Run is Run
    assert out["correct"] is True
    by = out["window"]["by_span"]
    assert {"engine.step", "engine.decode.issue", "engine.preempt",
            "engine.resume", "host_tier.issue"} <= set(by)
    assert by["engine.step"]["count"] == out["window"]["steps"]
    assert all(0 <= e["self_s"] <= e["total_s"] + 1e-9 for e in by.values())
    # the readers of the card's times are left out on the CPU, as run.py does
    assert set(out["metrics"]) == {"pauses_per_ktok", "streamed_share",
                                   "host_copy_gb_per_ktok"}
    assert out["metrics"]["host_copy_gb_per_ktok"] > 0
    assert "idle_by_span" not in out          # no trace on the CPU
    assert out["log_ns"]["off"] < out["log_ns"]["on"]


def test_span_report_alternates_the_log_on_the_cpu(monkeypatch):
    """``--log alternate``: the log on through the warm-up and on every
    other window step, off on the rest; each pair's ratio taken the right
    way round, less the collector's time; the fit finds the log's term;
    ``--log never`` records nothing; the runner's names put back."""
    from spanreport import alternating_driver, kept, log_cost, report
    from valetbench.harness import runner
    from valetbench.harness.drive import Driver
    out = report(tiny_cell("hymba-1.5b.long.pressure"), 2 ** 31 + 11, 1.5, "cpu",
                 time.perf_counter(), mode="alternate", log=lambda *a: None)
    assert not spans.enabled() and not spans.take()
    assert runner.Run is Run and runner.Driver is Driver
    assert out["correct"] is True
    c = out["cost"]
    assert c["steps_on"] + c["steps_off"] == len(c["steps"]) >= 2
    assert [on for on, *_ in c["steps"]] == [1, 0] * (len(c["steps"]) // 2) + \
        [1] * (len(c["steps"]) % 2)
    out = report(tiny_cell("hymba-1.5b.long.pressure"), 2 ** 31 + 11, 1.5, "cpu",
                 time.perf_counter(), mode="never", log=lambda *a: None)
    assert out["cost"]["steps_on"] == 0 and not spans.take()
    # a synthetic run: walls 1.0 (on), 1.2 (off, 0.1 s of it the collector's)
    run = make_run(window=(0.0, 3.0))
    for i, s in enumerate(run.served.steps):
        s.phase, s.t0, s.t1 = "window", float(i), i + (1.0, 1.2, 1.0, 1.2)[i]
    cost = log_cost(run, [True, False, True, False], [0.0, 0.1, 0.0, 0.1])
    assert cost["pairs"] == 3 and cost["pct"] == pytest.approx(100 / 1.1 - 100)
    assert cost["gc_s_off"] == pytest.approx(0.2) and cost["fit_ms"] is None
    # eight steps of 100 ms a decoded row and 5 ms more with the log on
    steps = [step(i, "window") for i in range(8)]
    for i, s in enumerate(steps):
        s.decodes = [0] * (1 + i // 2)
        s.t0, s.t1 = 10.0 * i, 10.0 * i + 0.1 * len(s.decodes) + 0.005 * (i % 2 == 0)
    run = Run(run.cell, Served(steps, {}, {}, (0.0, 80.0)), run.model, 1.0)
    cost = log_cost(run, [i % 2 == 0 for i in range(8)], [0.0] * 8)
    assert cost["fit_ms"][0] == pytest.approx(5.0) and cost["fit_ms"][1] < 1e-6
    with kept(runner, Driver=alternating_driver([], [])) as runs:
        assert runner.Driver is not Driver and runs == []
    assert runner.Driver is Driver and runner.Run is Run
