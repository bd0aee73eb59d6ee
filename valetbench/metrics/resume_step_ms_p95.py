"""95th percentile of the wall of the window's steps in which pages were
restored or a sequence recomputed, in ms; None when no step of the window
resumed anything."""
from valetbench.harness.runview import tail

DEVICE = True


def read(run):
    walls = [s.wall for s in run.window_steps()
             if s.counts["restored_pages"] or s.counts["recomputes"]]
    v = tail(walls, 95)
    return None if v is None else 1e3 * v
