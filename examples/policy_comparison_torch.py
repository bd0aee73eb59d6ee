"""Compare Valet against the paper's baselines end to end, on the PyTorch
port.

    PYTHONPATH=src python examples/policy_comparison_torch.py              # the card
    PYTHONPATH=src python examples/policy_comparison_torch.py --device cpu

Serves the same request stream with valet / infiniswap / os-swap under a
pool that fits only ~25% of the KV working set, and prints the paper's
headline comparison (completion time + behaviour counters).  All policies
produce identical tokens; they differ in what memory pressure costs.  On
the card the engine prefills through the flash kernel and decodes through
the paged kernel.  The port's counterpart of
``examples/policy_comparison.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.policies import POLICIES
from repro_torch.models import transformer as T
from repro_torch.serve import ValetServeEngine

POLICY_NAMES = ("valet", "infiniswap", "os-swap")


def run(params, cfg, device):
    """Serve the stream under each policy, print the table; returns
    {policy: (tokens per request, EngineStats)}."""
    ctx = T.ParallelCtx(remat=False, q_block=8, kv_block=8, loss_chunk=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=8) for _ in range(6)]

    results = {}
    for policy in POLICY_NAMES:
        eng = ValetServeEngine(params, cfg, ctx, max_batch=3, max_seq=64,
                               page=4, pool_slots=10,
                               policy=POLICIES[policy], device=device)
        for p in prompts:
            eng.submit(p, max_new=12)
        reqs = eng.run(max_steps=500)
        outs = [r.tokens_out for r in sorted(reqs, key=lambda r: r.rid)]
        results[policy] = (outs, eng.stats)

    ref = results["valet"][0]
    print(f"{'policy':12s} {'sim ms':>10s} {'pauses':>7s} {'spill':>6s} "
          f"{'restore':>8s} {'recompute':>9s} {'exact':>6s}")
    for policy, (outs, s) in results.items():
        print(f"{policy:12s} {s.sim_time_us/1e3:10.2f} {s.pauses:7d} "
              f"{s.spilled_pages:6d} {s.restored_pages:8d} "
              f"{s.recomputes:9d} {str(outs == ref):>6s}")
    v = results["valet"][1].sim_time_us
    i = results["infiniswap"][1].sim_time_us
    print(f"\nValet speedup over delete-eviction remote paging: {i/v:.1f}x")
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    cfg = reduced(ARCHS["granite-3-8b"])
    gen = torch.Generator(device=device).manual_seed(0)
    run(T.init_params(cfg, generator=gen, device=device), cfg, device)


if __name__ == "__main__":
    main()
