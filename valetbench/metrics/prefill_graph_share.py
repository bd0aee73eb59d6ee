"""Share of the window's ``engine.prefill.issue`` spans that hold an
``engine.prefill.replay``, in %: the prefills the engine issued as one
replay of a bucket's CUDA graph rather than launch by launch.  Read from
the port's span log, which only a traced run enables
(``harness/spanlog.py``); None without the log, without a prefill in the
window, or from a port whose log holds no prefill graph span at all (no
``engine.prefill.capture`` or ``engine.prefill.replay``)."""
from valetbench.harness import spanlog

DEVICE = True
__getattr__ = spanlog.steps_attr

GRAPH = ("engine.prefill.capture", "engine.prefill.replay")


def read(run):
    recs = spanlog.records()
    if recs is None or not spanlog.of_run(run, recs):
        return None
    if not any(r.name in GRAPH for r in recs):
        return None
    window = {s.index for s in run.window_steps()}
    issues = [i for i, r in enumerate(recs)
              if r.name == "engine.prefill.issue" and r.step in window]
    if not issues:
        return None
    replayed = {r.parent for r in recs if r.name == "engine.prefill.replay"}
    return 100.0 * sum(i in replayed for i in issues) / len(issues)
