"""Share of the traced steps' unprofiled wall in which no operation
(kernel, copy or fill) ran on the device, in %: 1 - (union of the device
intervals / the wall).  The steps are ``STEPS`` steady steps right after
the measured window, extended until one of them prefills.  The profiler
makes the host issue each operation slower and leaves the device's work
as it is, so the wall is the traced one less the profiler's cost per
device operation, read in the same run from the decode-only steps
(``Run.untraced_wall``); None where that cannot be read."""
STEPS = 12
DEVICE = True


def read(run):
    if run.trace is None:
        return None
    wall, busy = run.untraced_wall(), run.trace.busy_s()
    if wall is None or wall <= busy:
        return None
    return 100.0 * (1.0 - busy / wall)
