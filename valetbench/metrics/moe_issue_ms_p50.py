"""Median, over the window's decode steps, of the host's time inside the
step's ``moe.layer`` spans within ``engine.decode.issue``, in ms: the
dropless MoE's part of ``decode_issue_ms_p50`` (routing, the sort into
expert groups, the grouped-GEMM launches and the combine, as the host
issues them).  Read from the port's span log, which only a traced run
enables (``harness/spanlog.py``); None without the log or without such a
span in the window."""
from collections import defaultdict

from valetbench.harness import spanlog
from valetbench.harness.runview import tail

DEVICE = True
__getattr__ = spanlog.steps_attr


def read(run):
    recs = spanlog.records()
    if recs is None or not spanlog.of_run(run, recs):
        return None
    window = {s.index for s in run.window_steps()}
    per_step = defaultdict(int)
    for r in recs:
        if (r.name == "moe.layer" and r.step in window and r.parent >= 0
                and recs[r.parent].name == "engine.decode.issue"):
            per_step[r.step] += r.t1 - r.t0
    v = tail(list(per_step.values()), 50) if per_step else None
    return None if v is None else 1e-6 * v
