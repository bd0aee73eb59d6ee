"""The device trace of a run's profiled steps, and what is read from it.

``Tracer`` runs the profiler over a few steps.  On the host it records
only the harness's ``record_function`` labels (``vb.step`` around each
``step()``, ``vb.harness`` around the harness's own work between steps):
no operator events, shapes or stacks, which would slow the host-bound
steps they time.  On the device it records every operation.  The
profiler is readied a few steps before the trace starts, so that CUPTI's
start-up falls outside the traced steps.  ``TraceData`` keeps each device
operation's interval (a kernel, a copy or a fill) and the labelled host
spans; the device is busy where any operation runs, idle elsewhere in the
traced window, and each idle gap is put down to the host spans it
overlaps.
"""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Tuple

STEP, HARNESS = "vb.step", "vb.harness"


@dataclass
class TraceData:
    ops: List[Tuple[str, float, float]]       # device (name, start s, end s)
    spans: List[Tuple[str, float, float]]     # host (label, start s, end s)
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals, clipped to the window."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, names) -> float:
        """Summed device time of the operations whose names contain any of
        ``names``; None when none ran."""
        hits = [b - a for n, a, b in self.ops if any(k in n for k in names)]
        return sum(hits) if hits else None

    def step_ops(self) -> List[int]:
        """Device operations that started inside each ``vb.step`` span, in
        order (a step ends by copying its tokens to the host, so its
        device work runs inside its span)."""
        steps = [(a, b) for n, a, b in self.spans if n == STEP]
        starts = sorted(a for _, a, _ in self.ops)
        return [bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
                for a, b in steps]

    def launches(self, names) -> Dict[str, int]:
        """How many operations' names contain each of ``names``."""
        return {k: sum(1 for n, _, _ in self.ops if k in n) for k in names}

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def idle_by_label(self, step_labels: List[str]) -> Dict[str, float]:
        """Idle seconds by what the host was doing: each gap split over
        the labelled host spans it overlaps (the k-th ``vb.step`` span is
        the k-th traced step, labelled by ``step_labels``)."""
        labelled, k = [], 0
        for name, a, b in self.spans:
            if name == STEP:
                lab = step_labels[k] if k < len(step_labels) else "step"
                k += 1
            else:
                lab = "harness: bookkeeping and submit"
            labelled.append((lab, a, b))
        idle: Dict[str, float] = {}
        for a, b in self.gaps():
            covered = 0.0
            for lab, x, y in labelled:
                o = min(b, y) - max(a, x)
                if o > 0:
                    idle[lab] = idle.get(lab, 0.0) + o
                    covered += o
            if b - a - covered > 0:
                key = "host: outside the labelled spans"
                idle[key] = idle.get(key, 0.0) + (b - a - covered)
        return idle

    def breakdown(self, step_labels: List[str]) -> Dict[str, list]:
        """The device operations that took the most time, and the idle
        time by what the host was doing (at most 10 each)."""
        by_op: Dict[str, float] = {}
        for n, a, b in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (b - a)
        idle = self.idle_by_label(step_labels)
        top = lambda d: [[k[:200], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


class Tracer:
    """``with Tracer(cuda) as scope:`` readies the profiler;
    ``scope.start()`` starts the trace, which ends with the block;
    ``scope.step()`` and ``scope.harness()`` are the labels; ``data`` is
    read after exit.  Without ``cuda`` only the host's labels are kept."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.data: TraceData = None

    def _sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.autograd import _prepare_profiler
        from torch.autograd.profiler import profile
        self._sync()
        p = profile(use_device="cuda" if self.cuda else None, use_kineto=True)
        self._config, self._activities = p.config(), p.kineto_activities
        _prepare_profiler(self._config, self._activities)
        return self

    def start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import _enable_profiler
        self._sync()
        _enable_profiler(self._config, self._activities, {RecordScope.USER_SCOPE})

    @contextmanager
    def _label(self, name):
        from torch.profiler import record_function
        with record_function(name):
            yield

    def step(self):
        return self._label(STEP)

    def harness(self):
        return self._label(HARNESS)

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self._sync()
        self.data = read_events(_disable_profiler().events())
        return False


def read_events(events) -> TraceData:
    from torch.autograd import DeviceType
    ops, spans = [], []
    for e in events:
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not e.name().startswith("vb."):
                ops.append((e.name(), a, b))
        elif e.name() in (STEP, HARNESS):
            spans.append((e.name(), a, b))
    spans.sort(key=lambda s: s[1])
    window = (spans[0][1], spans[-1][2]) if spans else (0.0, 0.0)
    return TraceData(ops, spans, window)
