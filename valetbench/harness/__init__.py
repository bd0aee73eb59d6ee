"""The benchmark's own code: cells, traffic, weights, the serving loop, the
work counts, the trace reduction and the correctness check."""
