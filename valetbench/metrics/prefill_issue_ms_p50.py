"""Median of the window's ``engine.prefill.issue`` spans, in ms: the host's
time to issue one B=1 prefill (``DecodeBatch.prefill``: a replay of its
bucket's CUDA graph, or the model's prefill launch by launch), before its
argmax is read back.  Read from the port's span log, which only a traced
run enables (``harness/spanlog.py``); None without the log, without a
prefill in the window, or from a port that records no such span."""
from valetbench.harness import spanlog
from valetbench.harness.runview import tail

DEVICE = True
__getattr__ = spanlog.steps_attr


def read(run):
    recs = spanlog.window_spans(run, ("engine.prefill.issue",))
    v = tail([r.t1 - r.t0 for r in recs], 50) if recs else None
    return None if v is None else 1e-6 * v
