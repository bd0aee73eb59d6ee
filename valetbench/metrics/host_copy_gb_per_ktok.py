"""GB moved between the card and the host tier per 1000 generated tokens
over the window: the bytes of the window's ``host_tier.issue`` spans
(pool pages and per-slot blobs to the host), ``host_tier.stack`` spans
(streamed pages) and ``engine.seq_blob.write`` spans (blobs back), which
are the sites and the bytes of ``EngineStats.d2h_bytes`` and
``h2d_bytes``, over ``EngineStats.tokens``.  Read from the port's span
log, which only a traced run enables (``harness/spanlog.py``); None
without the log or without tokens."""
from valetbench.harness import spanlog

DEVICE = False
__getattr__ = spanlog.steps_attr
NAMES = ("host_tier.issue", "host_tier.stack", "engine.seq_blob.write")


def read(run):
    recs = spanlog.window_spans(run, NAMES)
    tok = run.count("tokens")
    if recs is None or not tok:
        return None
    return 1e-9 * sum(r.n for r in recs) / (1e-3 * tok)
