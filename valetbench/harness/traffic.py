"""One general generator of requests, read from a traffic file.

Lengths come from a fixed stratified grid: ``GRID`` prompt lengths and
``GRID`` output lengths, log-uniform over ``[min, max]``.  A generator of
fixed seed (``ORDER_SEED``) permutes each grid afresh every ``GRID``
requests, which pairs prompts with outputs and sets their order; the run's
seed draws the prompt token ids (and the weights).  So every seed serves
the same sizes in the same order: the engine's schedule (admissions,
pauses, restores) depends on lengths alone, so two seeds do the same work
and differ in the numbers it works on.  (With the order drawn from the
seed, ten seeds' 20 s windows of the granite pressure cell read 38.6 to
54.1 tokens/s on one H100: the order moved the work far more than the
noise did.)

``kind: closed``: ``clients`` clients; each sends its next request when
its last one finishes (``Traffic.next_request``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

GRID = 64           # lengths on each grid
ORDER_SEED = 0      # the fixed generator of the grids' order


def log_grid(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` lengths at the midpoints of ``n`` equal steps of log length."""
    u = (np.arange(n) + 0.5) / n
    return np.round(np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
                    ).astype(np.int64)


@dataclass
class Request:
    index: int          # the n-th request of the run
    prompt: np.ndarray  # int64 token ids
    max_new: int


class Traffic:
    def __init__(self, spec: Dict, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.order_rng = np.random.default_rng(ORDER_SEED)
        self.prompts = log_grid(spec["prompt"]["min"], spec["prompt"]["max"], GRID)
        self.outputs = log_grid(spec["output"]["min"], spec["output"]["max"], GRID)
        self._order: List[tuple] = []
        self.issued = 0

    # geometry ------------------------------------------------------------
    @property
    def max_seq(self) -> int:
        return int(self.spec["prompt"]["max"] + self.spec["output"]["max"] + 1)

    @property
    def concurrency(self) -> int:
        """The sequences the pool is sized for: the loop's clients."""
        return int(self.spec["clients"])

    def pool_slots(self) -> int:
        """The KV pool in pages: ``share`` of the pages that
        ``concurrency`` sequences need at the grid's mean final length
        (``of: mean``) or at the longest (``of: max``)."""
        page, pool = int(self.spec["page"]), self.spec["pool"]
        if pool["of"] == "max":
            per_seq = -(-self.max_seq // page)
        elif pool["of"] == "mean":
            per_seq = (self.prompts.mean() + self.outputs.mean()) / page
        else:
            raise ValueError(f"pool.of must be mean or max, not {pool['of']!r}")
        return int(pool["share"] * self.concurrency * per_seq)

    # requests ------------------------------------------------------------
    def _sizes(self):
        if not self._order:
            pp = self.order_rng.permutation(len(self.prompts))
            po = self.order_rng.permutation(len(self.outputs))
            self._order = list(zip(self.prompts[pp], self.outputs[po]))[::-1]
        return self._order.pop()

    def next_request(self) -> Request:
        p, o = self._sizes()
        toks = self.rng.integers(2, self.vocab, size=int(p), dtype=np.int64)
        r = Request(self.issued, toks, int(o))
        self.issued += 1
        return r
