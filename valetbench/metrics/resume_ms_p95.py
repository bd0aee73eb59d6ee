"""95th percentile of the window's ``engine.resume`` spans, in ms: the
engine's own time to bring a paused request back, measured in full (its
``make_room``, preemptions and flush included, since the request waits
for them).  Read from the port's span log, which only a traced run
enables (``harness/spanlog.py``); None without the log or without a
resume in the window."""
from valetbench.harness import spanlog
from valetbench.harness.runview import tail

DEVICE = True
__getattr__ = spanlog.steps_attr


def read(run):
    recs = spanlog.window_spans(run, ("engine.resume",))
    v = tail([r.t1 - r.t0 for r in recs], 95) if recs else None
    return None if v is None else 1e-6 * v
