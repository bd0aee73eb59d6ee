"""The port's span log (``repro_torch.core.spans``) as the benchmark reads
it: armed in traced runs only, read by the window's ``step()`` index, and
laid over the device trace's idle gaps.

The runner asks every per-layer reader of a cell for its ``STEPS`` before
the warm-up of a traced run on a card (``runner.trace_steps``), and at no
other time.  A reader of program spans answers through ``steps_attr``,
which arms the log there and answers 0, leaving the traced steps to the
other readers.  So the log records from the warm-up on in traced runs,
and the untraced runs, which give the end-to-end metrics, never enable
it.  A port without the log arms nothing, and its readers read None.

A record's ``step`` is the engine's ``step()`` index, which is the index
of the harness's ``StepRec``: the harness makes the engine and calls
``step()`` once per record.  So the records are a run's only where they
hold one ``engine.step`` for each of its steps, in order; the first run
that reads them claims them, and any other run reads None.  Stamps are ns on the profiler's clock
(``spans.now_ns``), so a span lies on the device trace's time base.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from valetbench.harness.trace import STEP

_armed = False
_taken: Optional[list] = None
_owner = None       # the Served that claimed the records


def _log():
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return spans


def arm() -> int:
    """Drop what the log holds and enable it; 0 (no traced steps)."""
    global _armed, _taken, _owner
    spans = _log()
    if spans is not None:
        spans.take()
        spans.enable()
        _armed, _taken, _owner = True, None, None
    return 0


def steps_attr(name: str):
    """A span reader's module ``__getattr__``: ``STEPS`` arms the log."""
    if name == "STEPS":
        return arm()
    raise AttributeError(name)


def records() -> Optional[list]:
    """Every record since ``arm``, taken from the port's log once (which
    is then off); None where the log was never armed."""
    global _taken
    if not _armed:
        return None
    if _taken is None:
        spans = _log()
        spans.disable()
        _taken = spans.take()
    return _taken


def of_run(run, recs) -> bool:
    """Whether ``recs`` are ``run``'s: one ``engine.step`` per step of the
    run, in order, and claimed by no other run."""
    global _owner
    if _owner is None:
        steps = [r.n for r in recs if r.name == "engine.step"]
        if steps != list(range(len(run.served.steps))):
            return False
        _owner = run.served
    return _owner is run.served


def window_spans(run, names) -> Optional[list]:
    """The records named in ``names`` of the window's steps; None without
    the log or where its records are not the run's."""
    recs = records()
    if recs is None or not of_run(run, recs):
        return None
    steps = {s.index for s in run.window_steps()}
    return [r for r in recs if r.name in names and r.step in steps]


def union_s(recs) -> float:
    """Seconds covered by the records' intervals, overlaps counted once."""
    total, end = 0, None
    for r in sorted(recs, key=lambda r: r.t0):
        if end is None or r.t0 > end:
            total += r.t1 - r.t0
            end = r.t1
        elif r.t1 > end:
            total += r.t1 - end
            end = r.t1
    return total * 1e-9


def self_segments(recs) -> List[tuple]:
    """Each record's interval less its children's, as (start s, end s,
    name), sorted: at any instant the innermost span covering it."""
    kids: List[List[int]] = [[] for _ in recs]
    for i, r in enumerate(recs):
        if r.parent >= 0:
            kids[r.parent].append(i)
    segs = []
    for i, r in enumerate(recs):
        t = r.t0
        for j in kids[i]:
            c = recs[j]
            if c.t0 > t:
                segs.append((t * 1e-9, c.t0 * 1e-9, r.name))
            t = max(t, c.t1)
        if r.t1 > t:
            segs.append((t * 1e-9, r.t1 * 1e-9, r.name))
    segs.sort()
    return segs


def idle_by_span(trace, step_labels: List[str], recs) -> Dict[str, float]:
    """``TraceData.idle_by_label``, with the idle inside each ``vb.step``
    span put down further to the innermost program span covering it, by
    the span's name; what no program span covers keeps the step's label.
    Without records it is ``idle_by_label`` itself.  The total is the
    same: time only moves from a step's label to a span's name."""
    idle = trace.idle_by_label(step_labels)
    if not recs:
        return idle
    segs = self_segments(recs)
    starts = [a for a, _, _ in segs]
    steps = [(a, b) for n, a, b in trace.spans if n == STEP]
    for ga, gb in trace.gaps():
        for k, (x, y) in enumerate(steps):
            lo, hi = max(ga, x), min(gb, y)
            if hi <= lo:
                continue
            lab = step_labels[k] if k < len(step_labels) else "step"
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(segs) and segs[i][0] < hi:
                a, b, name = segs[i]
                o = min(hi, b) - max(lo, a)
                if o > 0:
                    idle[name] = idle.get(name, 0.0) + o
                    idle[lab] -= o
                i += 1
    return {k: v for k, v in idle.items() if v > 1e-12}
