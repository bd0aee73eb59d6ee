"""Where a cell's host time and device idle go, by the port's spans, and
what the span log costs.

    python3 valetbench/spanreport.py --workload <cell> --seed <n> --seconds <s> \
        [--log traced|alternate|never]

From the root of a checkout, on a card.  The run is ``runner.run_cell``'s
own, check included; this script only keeps its ``Run`` and reads the
span log beside it.  One JSON line on standard output.

With ``--log traced`` (the default), the run ``run.py --trace 1`` makes,
with

- ``correct`` and ``metrics``: the result's, as a traced run reads them;
- ``window``: for each span name, its count, total and self seconds over
  the window's steps (self: less the spans inside it), the window's
  seconds and steps, and its median step;
- ``idle_by_label``: the traced steps' idle by the harness's labels (the
  result line's ``breakdown``), and ``idle_by_span``: the same idle with
  the part inside each step put down to the innermost program span;
- ``synced_copies``: every device operation that starts inside a
  ``host_tier.issue`` span or its ``host_tier.wait``, and whether each
  ends before that wait ends (the wait synchronises the copies' stream);
- ``log_ns``: what a span costs on this host, off and on (a loop of
  ``LOOP`` spans), and ``cost_per_step_ms``: that times the window's
  spans per step.

With ``--log alternate``, the run ``run.py --trace 0`` makes, with the log on
from the warm-up, as in a traced run, and in the window on and off on
alternate steps; ``cost``: what the log adds to a step, read two ways
(``log_cost``), and the cyclic collector's seconds in the window's steps
with the log on and off, with every window step's wall and collector
time.  With ``--log never`` the same run and readings with the log never
on.

``window_table`` and ``synced_copies`` are pure reads of a run and its
records; the rest is the driving, kept apart so that it can go once the
runner hands a traced run's records to its ``Run``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import err, prepare  # noqa: E402

LOOP = 100_000


def log_ns():
    """ns per ``with spans.span(...)`` with the log off and on."""
    from repro_torch.core import spans
    out = {}
    for state in ("off", "on"):
        (spans.enable if state == "on" else spans.disable)()
        t0 = time.perf_counter_ns()
        for i in range(LOOP):
            with spans.span("engine.flush", i, 1) as sp:
                sp.set(2)
        out[state] = (time.perf_counter_ns() - t0) / LOOP
        spans.disable()
        spans.take()
    return out


def window_table(run, recs):
    """Count, total and self seconds by span name over the window's steps."""
    inner = [0] * len(recs)
    for r in recs:
        if r.parent >= 0:
            inner[r.parent] += r.t1 - r.t0
    steps = {s.index for s in run.window_steps()}
    out = defaultdict(lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0})
    for r, kids in zip(recs, inner):
        if r.step in steps:
            e = out[r.name]
            e["count"] += 1
            e["total_s"] += 1e-9 * (r.t1 - r.t0)
            e["self_s"] += 1e-9 * (r.t1 - r.t0 - kids)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["self_s"]))


def synced_copies(trace, recs, steps):
    """Device operations starting in a ``host_tier.issue`` span or the
    ``host_tier.wait`` after it, against that wait's end."""
    traced = [r for r in recs if r.step in steps]
    n, late, worst = 0, 0, 0.0
    for i, r in enumerate(traced):
        if r.name != "host_tier.wait" or i == 0 \
                or traced[i - 1].name != "host_tier.issue":
            continue
        lo, hi = 1e-9 * traced[i - 1].t0, 1e-9 * r.t1
        for _, a, b in trace.ops:
            if lo <= a <= hi:
                n += 1
                worst = max(worst, b - hi)
                late += b > hi
    return {"ops": n, "ending_after_the_wait": late, "latest_end_past_it_s": worst}


def log_cost(run, on, gc_s):
    """The log's cost from a window run on and off on alternate steps:
    ``on[i]`` says whether step ``i`` ran with it on, ``gc_s[i]`` the
    collector's seconds in it.  Each step's wall is taken less its
    collector's time, which falls on steps at random.  ``pct``: over each
    two adjacent steps that prefill nothing and do the same
    (``StepRec.label``), the one with the log on over the other, the
    median less 1.  ``fit_ms``: the log's term, with its standard error,
    in a least-squares fit of every window step's wall to the step's
    work (decoded rows, prefilled tokens, pauses, streamed, repointed
    and flushed pages) and the log."""
    w = run.window_steps()
    net = {s.index: s.wall - gc_s[s.index] for s in w}
    ratios = [(net[a.index] / net[b.index]) if on[a.index]
              else (net[b.index] / net[a.index])
              for a, b in zip(w, w[1:])
              if not a.prefills and not b.prefills and a.label() == b.label()]
    q = statistics.quantiles(ratios, n=4) if len(ratios) > 1 else [None] * 3
    pct = lambda v: None if v is None else 100.0 * (v - 1.0)
    cols = [[1.0] * len(w), [float(on[s.index]) for s in w],
            [float(len(s.decodes)) for s in w], [float(sum(s.prefills)) for s in w]]
    cols += [[float(s.counts[k]) for s in w]
             for k in ("pauses", "streamed_pages", "repointed_pages", "flushed_pages")]
    cols = cols[:2] + [c for c in cols[2:] if len(set(c)) > 1]
    fit = None
    x = np.array(cols).T
    y = np.array([1e3 * net[s.index] for s in w])
    if len(w) > x.shape[1] + 2 and 0 < x[:, 1].sum() < len(w):
        beta, *_ = np.linalg.lstsq(x, y, rcond=None)
        resid = y - x @ beta
        var = resid @ resid / (len(w) - x.shape[1])
        se = np.sqrt(var * np.linalg.pinv(x.T @ x)[1, 1])
        fit = [float(beta[1]), float(se)]
    walls = [1e3 * s.wall for s in w]
    return {"pairs": len(ratios), "pct": pct(q[1]), "pct_q1": pct(q[0]),
            "pct_q3": pct(q[2]), "fit_ms": fit,
            "median_step_ms": statistics.median(walls),
            "steps_on": sum(on[s.index] for s in w),
            "steps_off": sum(not on[s.index] for s in w),
            "gc_s_on": sum(gc_s[s.index] for s in w if on[s.index]),
            "gc_s_off": sum(gc_s[s.index] for s in w if not on[s.index]),
            "window_s": run.window_s,
            "steps": [[int(on[s.index]), round(1e3 * s.wall, 3),
                       round(1e3 * gc_s[s.index], 3), s.label()] for s in w]}


@contextmanager
def kept(runner, **swap):
    """``runner``'s names swapped for the duration; yields the ``Run``s
    that ``run_cell`` makes meanwhile."""
    runs = []

    class KeptRun(runner.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    swap["Run"] = KeptRun
    old = {k: getattr(runner, k) for k in swap}
    for k, v in swap.items():
        setattr(runner, k, v)
    try:
        yield runs
    finally:
        for k, v in old.items():
            setattr(runner, k, v)


def alternating_driver(on, gc_s, never=False):
    """A ``Driver`` whose engine runs with the span log on, and in the
    window with it off on every other step (``never``: always off); fills
    ``on`` and ``gc_s``."""
    from repro_torch.core import spans
    from valetbench.harness.drive import Driver
    t = {"gc": 0.0, "t0": 0.0}

    def timed(phase, info):
        if phase == "start":
            t["t0"] = time.perf_counter()
        else:
            t["gc"] += time.perf_counter() - t["t0"]

    class Alternating(Driver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            spans.take()
            (spans.disable if never else spans.enable)()
            self.windowed = 0

        def step(self, phase, scope=None):
            if phase == "window" and not never:
                (spans.disable if self.windowed % 2 else spans.enable)()
                self.windowed += 1
            on.append(spans.enabled())
            gc0 = t["gc"]
            gc.callbacks.append(timed)
            try:
                return super().step(phase, scope)
            finally:
                gc.callbacks.remove(timed)
                gc_s.append(t["gc"] - gc0)

    return Alternating


def report(cell, seed: int, seconds: float, device: str, t_start: float,
           mode: str = "traced", log=err) -> dict:
    """One run of ``cell`` by ``runner.run_cell``, read by spans; ``mode``
    as ``--log``."""
    import torch
    from repro_torch.core import spans
    from valetbench.harness import runner, spanlog
    cuda = torch.device(device).type == "cuda"
    head = {"workload": cell.name, "seed": seed,
            "device": torch.cuda.get_device_name() if cuda else device}
    if mode != "traced":
        on, gc_s = [], []
        driver = alternating_driver(on, gc_s, never=mode == "never")
        with kept(runner, Driver=driver) as runs:
            out = runner.run_cell(cell, seed, seconds, False, device, t_start,
                                  log=log)
        spans.disable()
        spans.take()
        return {**head, "correct": out["correct"],
                "cost": log_cost(runs[-1], on, gc_s)}
    spanlog.arm()           # a traced run on a card arms it again, the same
    with kept(runner) as runs:
        out = runner.run_cell(cell, seed, seconds, True, device, t_start, log=log)
    run, recs = runs[-1], spanlog.records()
    window = run.window_steps()
    in_window = {s.index for s in window}
    per_step = sum(1 for r in recs if r.step in in_window) / len(window)
    cost = log_ns()
    res = {**head, "correct": out["correct"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "window": {"seconds": run.window_s, "steps": len(window),
                      "median_step_s": float(np.median([s.wall for s in window])),
                      "spans_per_step": per_step,
                      "by_span": window_table(run, recs)},
           "log_ns": cost,
           "cost_per_step_ms": {k: 1e-6 * v * per_step for k, v in cost.items()}}
    if run.trace is not None:
        labels = [s.label() for s in run.traced_steps()]
        res.update(idle_by_label=run.trace.idle_by_label(labels),
                   idle_by_span=spanlog.idle_by_span(run.trace, labels, recs),
                   traced_idle_s=run.trace.window_s - run.trace.busy_s(),
                   synced_copies=synced_copies(run.trace, recs,
                                               set(run.served.profiled)))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--log", choices=("traced", "alternate", "never"),
                    default="traced")
    args = ap.parse_args()
    prepare()
    import torch
    if not torch.cuda.is_available():
        err("needs a CUDA device")
        return 2
    from valetbench.harness.spec import load_cell
    cell = load_cell(args.workload)
    out = report(cell, args.seed, args.seconds, "cuda", T_START,
                 mode=args.log)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
