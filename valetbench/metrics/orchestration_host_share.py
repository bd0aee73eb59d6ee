"""Share of the window's wall that the engine spent in its orchestration,
in %: the union of the window's ``engine.make_room``, ``engine.preempt``,
``engine.flush``, ``engine.evict_dirty`` and ``engine.resume`` spans
(nested ones counted once) over the window's wall.  Read from the port's
span log, which only a traced run enables (``harness/spanlog.py``); None
without the log."""
from valetbench.harness import spanlog

DEVICE = True
__getattr__ = spanlog.steps_attr
NAMES = ("engine.make_room", "engine.preempt", "engine.flush",
         "engine.evict_dirty", "engine.resume")


def read(run):
    recs = spanlog.window_spans(run, NAMES)
    if recs is None:
        return None
    return 100.0 * spanlog.union_s(recs) / run.window_s
