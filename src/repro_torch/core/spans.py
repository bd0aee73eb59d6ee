"""The port's span log: named host intervals of the serving engine's work
and of the host-tier copies, on the clock of the profiler's events.

The log is process-wide and off by default.  ``span(name, rid, n)`` is a
context manager.  Off, it returns one shared object that does nothing.
On, entering appends one record to in-memory lists: the name, the start
and end in ns, the index of the enclosing open span (its parent), the
``step()`` index, the request's id and one integer (pages, bytes or rows,
as the site says).  A span opened with ``step=`` sets the step index of
itself and of every span inside it; the others take their parent's.
``take()`` returns the records and clears them; nothing is written out.
``mark(name, rid, n)`` records a span of no length, for a count.

Every stamp comes from ``now_ns``, on the clock that the profiler's
``KinetoEvent.start_ns`` reads (the Unix epoch in ns), so that a span and
a device operation of one trace share a time base.  Spans are entered and
left on one thread, so they nest and never overlap otherwise.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple


class Span(NamedTuple):
    name: str
    t0: int         # ns on now_ns's clock
    t1: int
    parent: int     # the enclosing span's index in take()'s list, or -1
    step: int       # the engine's step() index; -1 outside every step
    rid: int        # the request's id; -1 where the work serves none
    n: int          # pages, bytes or rows, by span


def now_ns() -> int:
    """The profiler's clock: ``KinetoEvent.start_ns`` reads the epoch."""
    return time.time_ns()


_on = False
_recs: List[list] = []      # [name, t0, t1, parent, step, rid, n]; a
                            # closed span's is a tuple, which the cyclic
                            # collector stops tracking, so a long log
                            # adds nothing to its passes
_open: List[int] = []       # indices of the open spans, innermost last


class _Off:
    """What ``span`` returns while the log is off: one shared instance."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, n: int) -> None:
        pass

    def drop(self) -> None:
        pass


_OFF = _Off()


class _Live:
    __slots__ = ("rec",)

    def __init__(self, name, rid, n, step):
        self.rec = [name, 0, 0, -1, step, rid, n]

    def __enter__(self):
        r = self.rec
        if _open:
            r[3] = _open[-1]
            if r[4] < 0:
                r[4] = _recs[r[3]][4]
        _open.append(len(_recs))
        _recs.append(r)
        r[1] = now_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = now_ns()
        _recs[_open.pop()] = tuple(self.rec)
        return False

    def set(self, n: int) -> None:
        """The span's integer, where it is known only at the end."""
        self.rec[6] = n

    def drop(self) -> None:
        """Keep no record of this span (a call that did not do what the
        name says); the spans inside it move to its parent."""
        self.rec[0] = None


def span(name: str, rid: int = -1, n: int = 0, step: int = -1):
    if not _on:
        return _OFF
    return _Live(name, rid, n, step)


def mark(name: str, rid: int = -1, n: int = 0) -> None:
    """A record of no length, now, inside the open span: a count ``n``
    that the host learns after the work it counts (one read back from the
    device with a step's tokens)."""
    if _on:
        parent = _open[-1] if _open else -1
        t = now_ns()
        _recs.append((name, t, t, parent, _recs[parent][4] if _open else -1, rid, n))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> List[Span]:
    """The records since the last ``take``, in the order their spans
    opened, and clear them.  Call it with no span open."""
    global _recs
    recs, _recs = _recs, []
    index, out = [-1] * len(recs), []
    for i, (name, t0, t1, parent, step, rid, n) in enumerate(recs):
        if name is None:
            continue
        while parent >= 0 and recs[parent][0] is None:
            parent = recs[parent][3]
        index[i] = len(out)
        out.append(Span(name, t0, t1, index[parent] if parent >= 0 else -1,
                        step, rid, n))
    return out
