"""What a metric reader gets: one run's records, read only."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from valetbench.harness.drive import Served, StepRec
from valetbench.harness.spec import Cell
from valetbench.harness.trace import TraceData
from valetbench.harness.work import Model


MIN_STEPS = 3       # decode-only steps each side for the profiler's cost


def tail(values, q: float) -> Optional[float]:
    """The q-th percentile of all ``values`` (numpy's linear interpolation
    between order statistics); None for no values."""
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None


@dataclass
class Run:
    cell: Cell
    served: Served
    model: Model
    setup_s: float
    trace: Optional[TraceData] = None

    @property
    def page(self) -> int:
        return int(self.cell.traffic["page"])

    @property
    def window(self):
        return self.served.window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def window_steps(self) -> List[StepRec]:
        return [s for s in self.served.steps if s.phase == "window"]

    def traced_steps(self) -> List[StepRec]:
        return [self.served.steps[i] for i in self.served.profiled]

    def profiler_cost(self) -> Optional[float]:
        """Host seconds the profiler adds per device operation: the traced
        decode-only steps' median wall less the window's decode-only
        median step, over the traced decode-only steps' median count of
        device operations.  (Once CUPTI is readied the host issues every
        later operation slower; the device's work stays the same.)  None
        with fewer than ``MIN_STEPS`` decode-only steps on either side."""
        if self.trace is None:
            return None
        ops = self.trace.step_ops()
        traced = [(s.wall, n) for s, n in zip(self.traced_steps(), ops)
                  if not s.prefills]
        window = [s.wall for s in self.window_steps() if not s.prefills]
        if len(traced) < MIN_STEPS or len(window) < MIN_STEPS:
            return None
        extra = float(np.median([w for w, _ in traced]) - np.median(window))
        return max(0.0, extra) / float(np.median([n for _, n in traced]))

    def untraced_wall(self) -> Optional[float]:
        """The traced window's wall less the profiler's cost of each of its
        device operations: what those steps take unprofiled."""
        cost = self.profiler_cost()
        if cost is None:
            return None
        return self.trace.window_s - cost * sum(self.trace.step_ops())

    def count(self, key: str, steps=None) -> int:
        return sum(s.counts[key] for s in (self.window_steps() if steps is None else steps))

    def in_window(self, t: float) -> bool:
        return self.window[0] < t <= self.window[1]
