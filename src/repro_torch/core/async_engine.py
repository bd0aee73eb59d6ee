"""Simulated background-daemon clock for the serve engine's async mode.

Only ``DaemonClock`` is ported here; the trace store's ``AsyncOrchestrator``
comes with the trace-driven control plane.
"""
from __future__ import annotations


class DaemonClock:
    """Simulated background-daemon clock (us, same axis as ``time_us``).

    ``at_us`` is the time at which the daemon becomes idle.  ``charge``
    appends work starting from ``max(at_us, now)`` (the daemon can't start
    before it is free *or* before the work exists); ``wait_for`` is the
    fence wait ``max(0, at_us - now)``.  ``AsyncOrchestrator`` keeps its
    inline ``daemon_clock`` float for bit-stability of the existing suites;
    the serve engine's async mode charges its demote/flush daemon through
    one of these.
    """

    def __init__(self):
        self.at_us = 0.0

    def charge(self, cost_us: float, now_us: float) -> float:
        """Schedule ``cost_us`` of daemon work at ``now_us``; returns it."""
        self.at_us = max(self.at_us, now_us) + cost_us
        return cost_us

    def wait_for(self, now_us: float) -> float:
        """Fence wait if the foreground synchronizes at ``now_us``."""
        w = self.at_us - now_us
        return w if w > 0.0 else 0.0
