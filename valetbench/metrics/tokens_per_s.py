"""Generated tokens per second: every token of the steps that ran in the
window (prefills' first tokens and decoded tokens), over the window's wall
seconds (from its start to the end of its last step)."""
DEVICE = True


def read(run):
    return run.count("tokens") / run.window_s
