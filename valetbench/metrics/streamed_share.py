"""Share of the pages restored in the window that were streamed back from
the host tier rather than repointed, in % (``streamed_pages`` over
``restored_pages``); None when nothing was restored."""
DEVICE = False


def read(run):
    restored = run.count("restored_pages")
    return 100.0 * run.count("streamed_pages") / restored if restored else None
