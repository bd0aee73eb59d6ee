"""The readers of the prefill's issue spans on synthetic span logs."""
import numpy as np
import pytest

from repro_torch.core.spans import Span
from valetbench.harness import spanlog
from valetbench.harness.drive import Served, StepRec
from valetbench.harness.runner import metric_module
from valetbench.harness.runview import Run
from valetbench.harness.work import Model
from vbtiny import tiny_cell

MS = 1_000_000      # ns
ZERO = {"tokens": 0, "pauses": 0, "restored_pages": 0, "streamed_pages": 0,
        "repointed_pages": 0, "recomputes": 0, "flushed_pages": 0}


def read(name, run):
    return metric_module(name).read(run)


def prefill_log(graphs=True):
    """A span log of four steps (0 warm-up, 1 and 2 the window, 3 after):
    step 0's prefill captures its bucket; step 1 prefills twice, one a
    replay of 0.5 ms and one unpadded of 40 ms; step 2 replays in 0.25 ms
    and recomputes with a replay of 0.75 ms; step 3 replays.  Without
    ``graphs`` every prefill is unpadded (a port with no prefill graph)."""
    out = []

    def rec(name, t0, t1, parent, s, n=0):
        out.append(Span(name, int(t0 * MS), int(t1 * MS), parent, s, -1, n))
        return len(out) - 1

    for s, issues in ((0, [("capture", 90.0)]), (1, [("replay", 0.5), (None, 40.0)]),
                      (2, [("replay", 0.25), ("recompute", 0.75)]), (3, [("replay", 0.3)])):
        base = 1000.0 * s
        top = rec("engine.step", base, base + 900, -1, s, n=s)
        for kind, ms in issues:
            outer = rec("engine.recompute" if kind == "recompute" else "engine.prefill",
                        base, base + ms + 1, top, s)
            issue = rec("engine.prefill.issue", base, base + ms, outer, s, n=100)
            if graphs and kind == "capture":
                rec("engine.prefill.capture", base + 1, base + ms, issue, s, n=4000)
            elif graphs and kind in ("replay", "recompute"):
                rec("engine.prefill.replay", base, base + ms / 2, issue, s, n=256)
            base += ms + 2
    return out


def prefill_run():
    steps = [StepRec(i, float(i), float(i + 1), dict(ZERO, tokens=10), [], [], ph)
             for i, ph in enumerate(("warmup", "window", "window", "after"))]
    cell = tiny_cell("granite-3-8b.chat.pressure")
    served = Served(steps, {}, {}, (1.0, 3.0), [], None)
    return Run(cell, served, Model(cell.config), 12.5, None)


def use_log(monkeypatch, records):
    monkeypatch.setattr(spanlog, "records", records)
    monkeypatch.setattr(spanlog, "_owner", None)


@pytest.mark.parametrize("graphs", [True, False])
def test_prefill_issue_median_of_the_window(monkeypatch, graphs):
    use_log(monkeypatch, lambda: prefill_log(graphs))
    # the window's issues: 0.5, 40, 0.25, 0.75 ms (capture and step 3 left out)
    assert read("prefill_issue_ms_p50", prefill_run()) == pytest.approx(
        np.percentile([0.5, 40.0, 0.25, 0.75], 50))
    use_log(monkeypatch, lambda: [r for r in prefill_log(graphs) if r.name == "engine.step"])
    assert read("prefill_issue_ms_p50", prefill_run()) is None


def test_prefill_graph_share_of_the_window(monkeypatch):
    use_log(monkeypatch, prefill_log)
    # three of the window's four issues hold a replay, a recompute's too
    assert read("prefill_graph_share", prefill_run()) == pytest.approx(75.0)
    # a port with no prefill graph span reads None, and so does no log
    use_log(monkeypatch, lambda: prefill_log(graphs=False))
    assert read("prefill_graph_share", prefill_run()) is None
    use_log(monkeypatch, lambda: None)
    assert read("prefill_graph_share", prefill_run()) is None
    assert read("prefill_issue_ms_p50", prefill_run()) is None
