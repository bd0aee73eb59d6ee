"""95th percentile of every gap between two consecutive tokens of one
request with both tokens in the window, in ms.  A token's time is the end
of the step that produced it; a gap that spans a pause counts; two tokens
of one step (an admission's first token and its first decode) give a gap
of 0."""
from valetbench.harness.runview import tail

DEVICE = True


def read(run):
    gaps = []
    for r in run.served.requests.values():
        ts = [t for t in r.token_times if run.in_window(t)]
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    v = tail(gaps, 95)
    return None if v is None else 1e3 * v
