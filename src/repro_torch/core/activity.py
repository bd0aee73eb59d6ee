"""Activity tracking + victim selection (paper §3.5).

``Non-Activity-Duration = now - last_write_activity`` per MR block; the
eviction victim is the block with the longest duration — likely in its idle
phase of the write->read->idle activity cycle the paper observes.  No
queries to sender nodes are needed: the timestamp tag lives with the block.

Two schemes:

* ``select_victims_nad`` — the paper's, on write timestamps.
* ``select_victims_mass`` — beyond-paper: for KV pages, "activity" can be the
  *attention mass* a page received recently (free from the flash-decode
  partials).  Same interface, better victims for read-heavy KV workloads.

``select_victims_topk`` is the batched fast path: an ``argpartition`` top-k
over the tracker's dense arrays that returns exactly the same victims (same
order, same tie-breaks) as ``select_victims_nad`` without a full sort.

Plus power-of-two-choices peer selection (§2.1 / §4.3) for placement and
migration destinations.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class ActivityTracker:
    """Per-block last-activity timestamps + optional attention-mass EMA.

    Dense-array backed: block ids index straight into grow-on-demand numpy
    arrays, so a whole candidate set's Non-Activity-Durations come from one
    vectorized gather (``nad``) instead of per-block dict probes — the
    enabling piece of the batched victim-selection path.  The paper's
    per-block metadata tag is exactly this: a timestamp updated on write.
    """

    def __init__(self, n_blocks: int = 0, mass_decay: float = 0.9):
        cap = max(int(n_blocks), 1024)
        self._last = np.zeros(cap, np.int64)
        self._mass: Optional[np.ndarray] = None   # lazily allocated
        self.mass_decay = mass_decay
        self._mass_age = 0

    def _ensure(self, max_id: int):
        """Grow the dense arrays to cover ``max_id`` (geometric growth)."""
        n = self._last.shape[0]
        if max_id < n:
            return
        new = max(n * 2, max_id + 1)
        grown = np.zeros(new, np.int64)
        grown[:n] = self._last
        self._last = grown
        if self._mass is not None:
            gm = np.zeros(new, np.float64)
            gm[:n] = self._mass
            self._mass = gm

    def on_write(self, blocks: Sequence[int], step: int):
        b = np.asarray(blocks, np.int64)
        if b.size == 0:
            return
        self._ensure(int(b.max()))
        self._last[b] = step

    def touch(self, block: int, step: int):
        """Single-block ``on_write`` (hot path helper)."""
        block = int(block)
        self._ensure(block)
        self._last[block] = step

    def on_write_at(self, blocks: Sequence[int], steps: Sequence[int]):
        """Scatter per-block write timestamps (blocks must be unique)."""
        b = np.asarray(blocks, np.int64)
        if b.size == 0:
            return
        self._ensure(int(b.max()))
        self._last[b] = np.asarray(steps, np.int64)

    def on_write_map(self, touch) -> None:
        """``on_write_at`` from a ``{block id: step}`` dict — the shape the
        bulk placement pass accumulates — without materializing two
        intermediate Python lists (one ``fromiter`` per array instead)."""
        n = len(touch)
        if not n:
            return
        b = np.fromiter(touch.keys(), np.int64, count=n)
        self._ensure(int(b.max()))
        self._last[b] = np.fromiter(touch.values(), np.int64, count=n)

    def on_read_mass(self, blocks: Sequence[int], mass: Sequence[float]):
        """Accumulate attention-mass observations (beyond-paper activity).

        Kept sequential: a block repeated within one call decays once per
        occurrence, like the original per-observation update."""
        self._mass_age += 1
        b = np.asarray(blocks, np.int64)
        if b.size == 0:
            return
        self._ensure(int(b.max()))
        if self._mass is None:
            self._mass = np.zeros(self._last.shape[0], np.float64)
        m_arr = self._mass
        decay = self.mass_decay
        for blk, m in zip(b.tolist(), mass):
            m_arr[blk] = m_arr[blk] * decay + float(m)

    def last(self, block: int) -> int:
        block = int(block)
        if block >= self._last.shape[0]:
            return 0
        return int(self._last[block])

    def nad(self, blocks: Sequence[int], step: int) -> np.ndarray:
        b = np.asarray(blocks, np.int64) if not isinstance(blocks, np.ndarray) \
            else blocks
        if b.size == 0:
            return np.empty(0, np.int64)
        self._ensure(int(b.max()))
        return step - self._last[b]

    def mass_of(self, blocks: Sequence[int]) -> np.ndarray:
        b = np.asarray(blocks, np.int64)
        if b.size == 0:
            return np.empty(0, np.float64)
        if self._mass is None:
            return np.zeros(b.size, np.float64)
        self._ensure(int(b.max()))
        return self._mass[b].astype(np.float64)


def select_victims_nad(tracker: ActivityTracker, candidates: Sequence[int],
                       n: int, step: int) -> List[int]:
    """Paper's activity-based victim selection: longest Non-Activity-Duration."""
    cand = np.asarray(candidates, np.int64)
    if cand.size == 0 or n <= 0:
        return []
    nad = tracker.nad(cand, step)
    order = np.argsort(-nad, kind="stable")
    return cand[order[:n]].tolist()


def select_victims_topk(tracker: ActivityTracker, candidates: Sequence[int],
                        n: int, step: int) -> List[int]:
    """Dense top-k victim selection: same result as ``select_victims_nad``
    (same victims, same order, same candidate-order tie-breaks) via
    ``argpartition`` instead of a full stable sort — O(C + k log k); accepts
    the dense candidate arrays ``peer_pressure`` now produces without a
    Python-list round trip."""
    cand = np.asarray(candidates, np.int64)
    if cand.size == 0 or n <= 0:
        return []
    neg = -tracker.nad(cand, step)
    if n >= cand.size:
        order = np.argsort(neg, kind="stable")
        return cand[order].tolist()
    kth = np.partition(neg, n - 1)[n - 1]
    strict = np.flatnonzero(neg < kth)
    ties = np.flatnonzero(neg == kth)[: n - strict.size]
    sel = np.concatenate([strict, ties])
    # stable argsort order == primary key neg ascending, ties by index
    sel = sel[np.lexsort((sel, neg[sel]))]
    return cand[sel].tolist()


def select_victims_mass(tracker: ActivityTracker, candidates: Sequence[int],
                        n: int, step: int) -> List[int]:
    """Beyond-paper: evict lowest recent attention mass (ties -> oldest)."""
    cand = np.asarray(candidates, np.int64)
    if cand.size == 0 or n <= 0:
        return []
    mass = tracker.mass_of(cand)
    nad = tracker.nad(cand, step)
    order = np.lexsort((-nad, mass))        # primary: low mass; tie: old
    return cand[order[:n]].tolist()


def select_victims_random(rng: np.random.Generator, candidates: Sequence[int],
                          n: int) -> List[int]:
    """Baseline (Infiniswap-like batched random selection, §6.5): same
    permutation draws as the list version, array-native candidates."""
    cand = np.asarray(candidates, np.int64)
    if not cand.size or n <= 0:
        return []
    idx = rng.permutation(cand.size)[:min(n, cand.size)]
    return cand[idx].tolist()


class PairSampler:
    """Buffered uniform distinct ordered pairs over ``range(k)``.

    ``power_of_two_choices`` needs one random peer pair per placement —
    once per flushed page on the remote-send path — and per-call Generator
    overhead dominates there.  Drawing a few thousand pairs at a time keeps
    the amortized cost near an array index.  Distribution is identical to
    the unbuffered two-draw scheme; only the stream consumption differs.

    ``draw_batch`` consumes exactly the pairs that the same number of
    sequential ``draw`` calls would (same buffer refill boundaries), so the
    batched flush path and the scalar reference stay on one pair stream.
    """

    def __init__(self, k: int, rng: np.random.Generator, buf: int = 4096):
        assert k >= 2
        self.k = k
        self.rng = rng
        self.buf = buf
        self._a = self._b = None
        self._i = 0

    def draw(self):
        if self._a is None or self._i >= self._a.shape[0]:
            self._a = self.rng.integers(0, self.k, size=self.buf)
            self._b = self.rng.integers(0, self.k - 1, size=self.buf)
            self._i = 0
        i = self._i
        self._i = i + 1
        a = int(self._a[i])
        b = int(self._b[i])
        if b >= a:
            b += 1
        return a, b

    def draw_batch(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``draw`` x n: returns (a, b) int arrays."""
        out_a = np.empty(n, np.int64)
        out_b = np.empty(n, np.int64)
        filled = 0
        while filled < n:
            if self._a is None or self._i >= self._a.shape[0]:
                self._a = self.rng.integers(0, self.k, size=self.buf)
                self._b = self.rng.integers(0, self.k - 1, size=self.buf)
                self._i = 0
            take = min(n - filled, self._a.shape[0] - self._i)
            out_a[filled:filled + take] = self._a[self._i:self._i + take]
            out_b[filled:filled + take] = self._b[self._i:self._i + take]
            self._i += take
            filled += take
        out_b[out_b >= out_a] += 1
        return out_a, out_b


def power_of_two_choices(free_counts: Sequence[int],
                         rng: np.random.Generator,
                         exclude: Sequence[int] = ()) -> Optional[int]:
    """Pick the freer of two random peers (paper §2.1, §4.3).

    The distinct pair is drawn with two ``integers`` draws (second index
    skips the first) — the same uniform ordered-pair distribution as
    ``rng.choice(k, 2, replace=False)`` at a fraction of its cost, which
    matters because placement runs once per flushed page.
    """
    if exclude:
        ex = set(exclude)
        peers = [i for i in range(len(free_counts)) if i not in ex]
    else:
        peers = list(range(len(free_counts)))
    if not peers:
        return None
    k = len(peers)
    if k == 1:
        return peers[0]
    a = int(rng.integers(k))
    b = int(rng.integers(k - 1))
    if b >= a:
        b += 1
    pa, pb = peers[a], peers[b]
    return pa if free_counts[pa] >= free_counts[pb] else pb
