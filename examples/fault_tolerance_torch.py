"""Fault tolerance end to end on the PyTorch port: async replicated
checkpoints, replica corruption, elastic-recovery planning, and
peer-failure page recovery.

    PYTHONPATH=src python examples/fault_tolerance_torch.py                # the card
    PYTHONPATH=src python examples/fault_tolerance_torch.py --device cpu

The port's counterpart of ``examples/fault_tolerance.py``.
"""
import argparse
import os
import tempfile

import torch

from repro_torch import optim
from repro_torch.bridge import tree_flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import (PAPER_COSTS, POLICIES, OrchestrationConfig,
                              TieredPageStore)
from repro_torch.data import DataConfig, TrainDataset
from repro_torch.models import transformer as T
from repro_torch.train import (ClusterSpec, TrainConfig, ValetCheckpointer,
                               fit, make_recovery_plan)


def run(params, cfg, device):
    """Train, snapshot, corrupt and restore, resume, plan, fail a peer;
    returns {exact, restore_step, hist, hist2, plan, recovered, lost}."""
    ctx = T.ParallelCtx(remat=False, q_block=16, kv_block=16, loss_chunk=16,
                        compute_dtype=torch.float32)
    tcfg = TrainConfig(microbatches=2, compute_dtype=torch.float32,
                       adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=40))
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    out = {}

    with tempfile.TemporaryDirectory() as d:
        ckpt = ValetCheckpointer(d, replicas=2)

        # train 20 steps, checkpoint asynchronously (staging = critical path)
        params, opt, hist = fit(params, cfg, ctx, tcfg, ds, n_steps=20,
                                log_every=10)
        stage_s = ckpt.save(20, {"params": params})
        ckpt.wait()
        print(f"[ckpt] staged in {stage_s*1e3:.1f} ms "
              f"(writer replicates to 2 dirs in the background)")

        # corrupt the primary replica -> restore falls back (Table 3)
        r0 = os.path.join(d, "replica0", "step_00000020", "arrays.npz")
        with open(r0, "wb") as f:
            f.write(b"corrupted!")
        step, restored = ckpt.restore_tensors(device=device,
                                              tree_like={"params": params})
        ok = all(torch.equal(a, b) for a, b in
                 zip(tree_flatten(restored["params"])[0],
                     tree_flatten(params)[0]))
        print(f"[ckpt] primary corrupted -> restored step {step} from "
              f"replica 1, exact={ok}")

        # resume training from the snapshot: the deterministic pipeline
        # replays the exact stream position
        ds2 = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=8), start_step=20)
        _, _, hist2 = fit(restored["params"], cfg, ctx, tcfg, ds2,
                          n_steps=5, log_every=2)
        print(f"[resume] loss continues from {hist[-1]['loss']:.3f} -> "
              f"{hist2[-1]['loss']:.3f}")
        ckpt.close()
    out.update(exact=ok, restore_step=step, hist=hist, hist2=hist2)

    # elastic: lose 37 of 512 devices -> recovery plan keeps TP=16
    spec = ClusterSpec(n_pods=2, data_parallel=16, model_parallel=16)
    plan = make_recovery_plan(spec, alive_devices=list(range(512 - 37)),
                              restore_step=20)
    m = plan["mesh"]
    print(f"[elastic] 512->{512-37} devices: new mesh pods={m.n_pods} "
          f"dp={m.data_parallel} tp={m.model_parallel} "
          f"({m.n_devices} used), resume at step {plan['restore_step']}")

    # remote peer failure: replicated pages recover without data loss
    store = TieredPageStore.from_config(OrchestrationConfig(
        policy=POLICIES["valet"], costs=PAPER_COSTS, pool_capacity=256,
        min_pool=32, n_peers=6, peer_capacity_blocks=128, pages_per_block=16))
    for p in range(1000):
        store.write(p)
    store.drain()
    recovered, lost = store.fail_peer(2)
    print(f"[peer-failure] peer 2 died: {recovered} pages repointed to "
          f"replicas, {lost} lost")
    out.update(plan=plan, recovered=recovered, lost=lost)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    cfg = reduced(ARCHS["phi3-mini-3.8b"])
    gen = torch.Generator(device=device).manual_seed(0)
    run(T.init_params(cfg, generator=gen, device=device), cfg, device)


if __name__ == "__main__":
    main()
