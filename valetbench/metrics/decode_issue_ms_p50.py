"""Median of the window's ``engine.decode.issue`` spans, in ms: the host's
time to issue one batched decode step (``models.decode.decode_step``,
every layer's kernels and copies, before the argmax is read back).  Read
from the port's span log, which only a traced run enables
(``harness/spanlog.py``); None without the log or without a decode in
the window."""
from valetbench.harness import spanlog
from valetbench.harness.runview import tail

DEVICE = True
__getattr__ = spanlog.steps_attr


def read(run):
    recs = spanlog.window_spans(run, ("engine.decode.issue",))
    v = tail([r.t1 - r.t0 for r in recs], 50) if recs else None
    return None if v is None else 1e-6 * v
