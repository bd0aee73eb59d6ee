"""Preemptions per 1000 generated tokens over the window
(``EngineStats.pauses`` over ``EngineStats.tokens``); None when the
window generated nothing."""
DEVICE = False


def read(run):
    tok = run.count("tokens")
    return 1e3 * run.count("pauses") / tok if tok else None
