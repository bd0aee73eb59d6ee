"""Quickstart on the PyTorch port: train a small LM, then serve it through
the Valet engine under memory pressure.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

30 training steps of a reduced gemma3 on the synthetic copy task with the
port's ``fit``, then generation under pool pressure with the Valet policy:
the outputs are identical to a pressure-free engine's (the point of the
paper).  The port's counterpart of ``examples/quickstart.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.policies import POLICIES
from repro_torch.data import DataConfig, TrainDataset
from repro_torch.models import transformer as T
from repro_torch.serve import ValetServeEngine
from repro_torch.train import TrainConfig, fit


def run(params, cfg, device):
    """Train ``params`` (a reduced gemma3's), then serve with and without
    pool pressure; returns (history, tokens unpressured, tokens under
    pressure, the pressured run's EngineStats)."""
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab} device={device}")

    ctx = T.ParallelCtx(remat=False, q_block=16, kv_block=16, loss_chunk=16,
                        compute_dtype=torch.float32)

    # -- train ---------------------------------------------------------------
    tcfg = TrainConfig(microbatches=2, compute_dtype=torch.float32,
                       adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=40))
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    params, _, hist = fit(params, cfg, ctx, tcfg, ds, n_steps=30,
                          log_every=10)
    for h in hist:
        print(f"step {h['step']:3d}  loss {h['loss']:.3f}")

    # -- serve under memory pressure ------------------------------------------
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=8) for _ in range(4)]

    def generate(pool_slots):
        eng = ValetServeEngine(params, cfg, ctx, max_batch=2, max_seq=48,
                               page=4, pool_slots=pool_slots,
                               policy=POLICIES["valet"], device=device)
        for p in prompts:
            eng.submit(p, max_new=8)
        reqs = eng.run()
        return ([r.tokens_out for r in sorted(reqs, key=lambda r: r.rid)],
                eng.stats)

    full, _ = generate(pool_slots=64)          # everything fits
    tight, stats = generate(pool_slots=5)      # ~25% working-set fit
    print(f"\npool pressure: pauses={stats.pauses} "
          f"spilled={stats.spilled_pages} restored={stats.restored_pages}")
    print("outputs identical under pressure:", full == tight)
    for i, toks in enumerate(tight):
        print(f"  req{i}: {toks}")
    return hist, full, tight, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    cfg = reduced(ARCHS["gemma3-4b"])          # tiny same-family config
    gen = torch.Generator(device=device).manual_seed(0)
    run(T.init_params(cfg, generator=gen, device=device), cfg, device)


if __name__ == "__main__":
    main()
