"""The metric readers on synthetic records."""
import numpy as np
import pytest

from valetbench.harness.drive import ReqRec, Served, StepRec
from valetbench.harness.runner import metric_module, trace_summary
from valetbench.harness.runview import Run, tail
from valetbench.harness.trace import TraceData
from valetbench.harness.work import Model
from vbtiny import tiny_cell

ZERO = {"tokens": 0, "pauses": 0, "restored_pages": 0, "streamed_pages": 0,
        "repointed_pages": 0, "recomputes": 0, "flushed_pages": 0}


def step(i, t0, t1, phase, prefills=(), decodes=(), **counts):
    return StepRec(i, t0, t1, dict(ZERO, **counts), list(prefills), list(decodes), phase)


def make_run(steps, requests, window, trace=None, profiled=()):
    cell = tiny_cell("granite-3-8b.chat.pressure")
    served = Served(steps, {r.rid: r for r in requests}, {}, window, list(profiled),
                    trace)
    return Run(cell, served, Model(cell.config), 12.5, trace)


def read(name, run):
    return metric_module(name).read(run)


def test_tail_is_over_all_samples():
    v = list(range(1, 201))               # 200 samples
    assert tail(v, 95) == pytest.approx(np.percentile(v, 95))
    # not the median of per-chunk tails
    chunks = [np.percentile(v[i:i + 20], 95) for i in range(0, 200, 20)]
    assert tail(v, 95) != pytest.approx(float(np.median(chunks)))
    assert tail([], 95) is None


def test_tokens_per_s_counts_window_steps_only():
    steps = [step(0, 0.0, 1.0, "warmup", tokens=100),
             step(1, 1.0, 2.0, "window", tokens=30),
             step(2, 2.0, 3.5, "window", tokens=50),
             step(3, 3.5, 4.0, "after", tokens=70)]
    run = make_run(steps, [], (1.0, 3.5))
    assert read("tokens_per_s", run) == pytest.approx(80 / 2.5)
    assert read("setup_s", run) == 12.5


def test_itl_clips_to_the_window_and_keeps_pause_gaps():
    r1 = ReqRec(0, 0, 10, 5, token_times=[0.5, 1.2, 1.4, 3.0, 5.0])
    r2 = ReqRec(1, 1, 10, 3, token_times=[1.5, 1.5, 2.0])
    run = make_run([], [r1, r2], (1.0, 4.0))
    # in (1, 4]: r1 1.2 1.4 3.0 -> 0.2, 1.6 (a pause); r2 1.5 1.5 2.0 -> 0, 0.5
    want = np.percentile([0.2, 1.6, 0.0, 0.5], 95) * 1e3
    assert read("itl_p95_ms", run) == pytest.approx(want)
    assert read("itl_p95_ms", make_run([], [], (1.0, 4.0))) is None


def test_counter_ratios_and_zero_denominators():
    steps = [step(0, 0.0, 1.0, "window", tokens=400, pauses=6, restored_pages=40,
                  streamed_pages=10, repointed_pages=30),
             step(1, 1.0, 3.0, "window", tokens=600)]
    run = make_run(steps, [], (0.0, 3.0))
    assert read("pauses_per_ktok", run) == pytest.approx(6.0)
    assert read("streamed_share", run) == pytest.approx(25.0)
    assert read("resume_step_ms_p95", run) == pytest.approx(1000.0)
    idle = make_run([step(0, 0.0, 1.0, "window")], [], (0.0, 1.0))
    assert read("pauses_per_ktok", idle) is None
    assert read("streamed_share", idle) is None
    assert read("resume_step_ms_p95", idle) is None


def test_serve_mfu_counts_prefills_and_decodes():
    steps = [step(0, 0.0, 2.0, "window", prefills=[30], decodes=[10, 20], tokens=3)]
    run = make_run(steps, [], (0.0, 2.0))
    m = run.model
    want = 100 * (m.prefill_flops(30) + m.decode_flops(10) + m.decode_flops(20)) / (2 * 989e12)
    assert read("serve_mfu", run) == pytest.approx(want)


def trace_data():
    ops = [("void paged_split_kernel<float>", 0.10, 0.15),
           ("paged_combine_kernel", 0.15, 0.16),
           ("flash_tc_kernel", 0.30, 0.50),
           ("Memcpy HtoD (Pinned -> Device)", 0.45, 0.60)]
    spans = [("vb.step", 0.0, 0.7), ("vb.harness", 0.7, 0.8), ("vb.step", 0.8, 1.0)]
    return TraceData(ops, spans, (0.0, 1.0))


def test_trace_busy_gaps_and_breakdown():
    t = trace_data()
    assert t.busy_s() == pytest.approx(0.06 + 0.30)
    assert t.kernel_s(["paged_split", "paged_combine"]) == pytest.approx(0.06)
    assert t.kernel_s(["ssd_"]) is None
    bd = t.breakdown(["step: a", "step: b"])
    assert bd["device_ops"][0][0] == "flash_tc_kernel"
    idle = dict(bd["idle_gaps"])
    assert idle["step: a"] == pytest.approx(0.10 + 0.14 + 0.10)
    assert idle["harness: bookkeeping and submit"] == pytest.approx(0.1)
    assert idle["step: b"] == pytest.approx(0.2)


def test_rooflines_and_idle_from_a_trace():
    steps = [step(0, 0.0, 0.7, "after", prefills=[32], decodes=[40, 50]),
             step(1, 0.8, 1.0, "after", decodes=[41, 51])]
    run = make_run(steps, [], (0.0, 0.0), trace_data(), profiled=[0, 1])
    m, page = run.model, run.page
    want = 100 * (m.paged_bound([40, 50], page) + m.paged_bound([41, 51], page)) / 0.06
    assert read("paged_attn_roofline", run) == pytest.approx(want)
    assert read("flash_attn_roofline", run) == pytest.approx(
        100 * m.flash_bound([32]) / 0.20)
    assert read("ssd_scan_roofline", run) is None          # no SSD launches
    # one decode-only step cannot price the profiler: no idle share
    assert run.profiler_cost() is None
    assert read("device_idle_share", run) is None
    untraced = make_run(steps, [], (0.0, 0.0))
    for name in ("paged_attn_roofline", "flash_attn_roofline", "device_idle_share"):
        assert read(name, untraced) is None


def priced_run(window_wall, n_decode_only=3):
    """Traced decode-only steps of 0.5 s with 10 device operations of
    0.01 s each, then a prefill step of 0.8 s with 20; window decode-only
    steps of ``window_wall``."""
    spans, ops, steps, t = [], [], [], 0.0
    for k in range(n_decode_only + 1):
        prefill = k == n_decode_only
        wall, n = (0.8, 20) if prefill else (0.5, 10)
        spans.append(("vb.step", t, t + wall))
        ops += [("k", t + 0.02 * i, t + 0.02 * i + 0.01) for i in range(n)]
        steps.append(step(k, t, t + wall, "after", prefills=[64] if prefill else [],
                          decodes=[70]))
        t += wall
    steps += [step(len(steps) + i, -3.0 + i, -3.0 + i + window_wall, "window",
                   decodes=[70]) for i in range(3)]
    return make_run(steps, [], (-3.0, -0.5), TraceData(ops, spans, (0.0, t)),
                    profiled=list(range(n_decode_only + 1)))


def test_idle_share_takes_the_profilers_cost_off_the_traced_wall():
    run = priced_run(0.4)
    assert run.trace.step_ops() == [10, 10, 10, 20]
    assert run.profiler_cost() == pytest.approx(0.01)      # 0.1 s over 10 operations
    assert run.untraced_wall() == pytest.approx(2.3 - 50 * 0.01)
    assert read("device_idle_share", run) == pytest.approx(100 * (1 - 0.5 / 1.8))
    # a profiler that cost nothing leaves the traced wall
    assert read("device_idle_share", priced_run(0.6)) == pytest.approx(100 * (1 - 0.5 / 2.3))
    # too few decode-only steps to price it: no idle share, the rooflines stay
    few = priced_run(0.4, n_decode_only=2)
    assert read("device_idle_share", few) is None
    lines = trace_summary(run) + trace_summary(few)
    assert "10000.000 us per device operation over 50" in lines[1]
    assert "of 1.8000 s unprofiled" in lines[1] and "none read" in lines[3]


def test_tracer_keeps_only_the_harness_labels_on_the_host(monkeypatch):
    import torch
    from valetbench.harness import trace
    names = []
    real = trace.read_events

    def keep(events):
        names.extend(e.name() for e in events)
        return real(events)
    monkeypatch.setattr(trace, "read_events", keep)
    x = torch.randn(32, 32)
    with trace.Tracer(cuda=False) as scope:
        x = x @ x                               # before the trace starts
        scope.start()
        for _ in range(2):
            with scope.step():
                x = torch.relu(x @ x) / 1e3
            with scope.harness():
                x.sum()
    assert set(names) == {"vb.step", "vb.harness"}
    assert [s[0] for s in scope.data.spans] == ["vb.step", "vb.harness"] * 2
    assert scope.data.ops == [] and scope.data.window_s > 0
