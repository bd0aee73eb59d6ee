"""Deterministic synthetic data pipeline (tokens + access traces).

Training batches are a pure function of (seed, step, shard) so that

* restarts resume exactly (fault tolerance),
* elastic resharding is a renumbering, not a reshuffle,
* every host materializes only its shard.

The trace generators reproduce the paper's workload mixes: Facebook ETC
(95% GET / 5% SET) and SYS (75/25) over zipfian keys [21], driven through
the TieredPageStore by the benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np



@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _fold(seed: int, *xs: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(seed) * np.uint64(0x9E3779B9)
                                 + sum(np.uint64(x) << (i * 16)
                                       for i, x in enumerate(xs)))


def batch_for_step(cfg: DataConfig, step: int, shard: int, n_shards: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) for one shard of one step.  Pure & deterministic.

    Synthetic LM task with learnable structure: a marker token induces a
    copy pattern, so training loss measurably decreases (integration tests
    assert this).
    """
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rng = _fold(cfg.seed, step, shard)
    toks = rng.integers(2, cfg.vocab, size=(b, cfg.seq_len + 1),
                        dtype=np.int64)
    # plant short periodic copies: token[t] == token[t-4] on marked runs
    for i in range(b):
        start = int(rng.integers(0, max(cfg.seq_len // 2, 1)))
        length = min(cfg.seq_len - start, int(rng.integers(8, 64)))
        toks[i, start] = 1                                  # marker
        for t in range(start + 4, start + length):
            toks[i, t] = toks[i, t - 4]
    return toks[:, :-1], toks[:, 1:]


class TrainDataset:
    """Iterator over global-step batches for a fixed shard layout."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        out = batch_for_step(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return out

    def reshard(self, shard: int, n_shards: int) -> "TrainDataset":
        """Elastic scaling: same stream, new shard layout, same step."""
        return TrainDataset(self.cfg, shard, n_shards, self.step)


# --------------------------------------------------------------------------
# Access traces (paper workloads)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceConfig:
    n_pages: int
    n_ops: int
    get_fraction: float        # ETC: 0.95, SYS: 0.75
    zipf_a: float = 1.2
    seed: int = 0


ETC = lambda pages, ops, seed=0: TraceConfig(pages, ops, 0.95, seed=seed)
SYS = lambda pages, ops, seed=0: TraceConfig(pages, ops, 0.75, seed=seed)


def generate_trace(cfg: TraceConfig):
    """Yield ("read"|"write", page) ops with zipfian key popularity."""
    rng = np.random.default_rng(cfg.seed)
    keys = np.clip(rng.zipf(cfg.zipf_a, cfg.n_ops), 1, cfg.n_pages) - 1
    # zipf rank -> random page id (so hot pages are spread out)
    perm = rng.permutation(cfg.n_pages)
    is_get = rng.random(cfg.n_ops) < cfg.get_fraction
    for k, g in zip(keys, is_get):
        yield ("read" if g else "write", int(perm[k]))
