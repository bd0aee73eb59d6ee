"""Bounded, deterministic latency reservoir for percentile reporting.

``Stats`` aggregates used to be mean-only (total ``time_us`` / ``ops``); the
async orchestration work is judged on *tail* latency, so per-op critical-path
latencies are streamed into this reservoir and ``latency_p50()`` /
``latency_p99()`` read percentiles out of it.

The reservoir is bounded (default 64Ki samples) and fully deterministic: no
RNG is involved, so two runs over the same trace produce identical
percentiles (required — the ``tail_latency`` benchmark is CI-gated on the
sync/async p99 ratio).  When the buffer fills, it is decimated in place
(every other retained sample is kept) and the acceptance stride doubles, so
the retained set is always "every ``stride``-th observation", a uniform
systematic sample of the stream.
"""
from __future__ import annotations

import numpy as np


class LatencyReservoir:
    """Streaming systematic sample of a latency series (microseconds)."""

    __slots__ = ("_cap", "_buf", "_n", "_stride", "_seen")

    def __init__(self, cap: int = 1 << 16):
        if cap < 2:
            raise ValueError("reservoir cap must be >= 2")
        self._cap = int(cap)
        self._buf = np.empty(self._cap, np.float64)
        self._n = 0          # filled prefix of _buf
        self._stride = 1     # keep every _stride-th observation
        self._seen = 0       # total observations offered

    # -- recording ---------------------------------------------------------

    def reset(self) -> None:
        """Drop every sample (benchmarks reset after their warm-up phase)."""
        self._n = 0
        self._stride = 1
        self._seen = 0

    def record(self, us: float) -> None:
        self.record_many(np.asarray([us], np.float64))

    def record_many(self, lats) -> None:
        arr = np.asarray(lats, np.float64).ravel()
        if arr.size == 0:
            return
        if self._stride > 1:
            off = (-self._seen) % self._stride
            self._seen += arr.size
            arr = arr[off::self._stride]
        else:
            self._seen += arr.size
        i = 0
        while i < arr.size:
            take = min(self._cap - self._n, arr.size - i)
            self._buf[self._n:self._n + take] = arr[i:i + take]
            self._n += take
            i += take
            if self._n == self._cap:
                half = self._cap // 2
                self._buf[:half] = self._buf[: 2 * half:2].copy()
                self._n = half
                self._stride *= 2
                arr = arr[i::2]
                i = 0

    # -- reading -----------------------------------------------------------

    @property
    def count(self) -> int:
        """Total observations offered (not the retained sample size)."""
        return self._seen

    def __len__(self) -> int:
        return self._n

    def percentile(self, q: float) -> float:
        """q-th percentile of the retained sample (0.0 when empty)."""
        if self._n == 0:
            return 0.0
        return float(np.percentile(self._buf[:self._n], q))

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)

    def p999(self) -> float:
        """99.9th percentile — the SLO-grade tail the workload suite gates.

        Resolution note: p999 needs >= ~1000 retained samples to sit above
        p99; the default 64Ki cap keeps exact streams up to 64Ki ops and a
        stride-decimated systematic sample beyond, which is still an
        unbiased p999 estimator for the deterministic traces we replay."""
        return self.percentile(99.9)

    def summary(self) -> dict:
        """p50/p90/p99/p999/max over the retained sample plus counts."""
        if self._n == 0:
            return {"count": 0, "p50_us": 0.0, "p90_us": 0.0,
                    "p99_us": 0.0, "p999_us": 0.0, "max_us": 0.0}
        live = self._buf[:self._n]
        return {
            "count": self._seen,
            "p50_us": float(np.percentile(live, 50.0)),
            "p90_us": float(np.percentile(live, 90.0)),
            "p99_us": float(np.percentile(live, 99.0)),
            "p999_us": float(np.percentile(live, 99.9)),
            "max_us": float(live.max()),
        }


from dataclasses import dataclass, field  # noqa: E402  (mixin below)


@dataclass
class LatencyStatsMixin:
    """Shared reservoir-backed latency surface for stats dataclasses.

    ``Stats`` (trace store) and ``EngineStats`` (serving engine) both carry
    a per-op critical-path reservoir behind ``latency_p50/p99/p999`` and —
    since the async engines fence on the background daemon — a per-fence
    wait reservoir behind ``fence_wait_p50/p99``.  Both stats classes
    inherit this mixin instead of copy-pasting the accessors.

    The reservoirs are excluded from dataclass equality: two bitwise-equal
    call paths may sample through different entry points (scalar loop vs
    ``access_batch``), and the parity suites compare the counters, not the
    sampling stream.
    """

    # per-op critical-path latency samples (us)
    lat: LatencyReservoir = field(default_factory=LatencyReservoir,
                                  compare=False, repr=False)
    # per-fence simulated wait samples (us); empty in synchronous mode
    fence_lat: LatencyReservoir = field(default_factory=LatencyReservoir,
                                        compare=False, repr=False)

    def latency_p50(self) -> float:
        """Median critical-path op latency (simulated us)."""
        return self.lat.p50()

    def latency_p99(self) -> float:
        """99th-percentile critical-path op latency (simulated us)."""
        return self.lat.p99()

    def latency_p999(self) -> float:
        """99.9th-percentile critical-path op latency (us, SLO tail)."""
        return self.lat.p999()

    def fence_wait_p50(self) -> float:
        """Median simulated wait absorbed by one daemon fence (us)."""
        return self.fence_lat.p50()

    def fence_wait_p99(self) -> float:
        """99th-percentile simulated wait absorbed by one fence (us)."""
        return self.fence_lat.p99()

    def fence_summary(self) -> dict:
        """Reservoir summary of per-fence waits (count/p50/p99/... us)."""
        return self.fence_lat.summary()
