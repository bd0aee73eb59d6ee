"""Training launcher: the port's ``fit`` on one device, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --local --steps 5 --device cpu

``--local`` trains the reduced config.  The weights are random, made from
seed 0 as the reference's ``PRNGKey(0)``, and the data is ``TrainDataset``'s
deterministic stream.  Checkpoints go through ``ValetCheckpointer`` (every
50 steps and at the end) into ``--ckpt-dir``, a fresh temporary directory
unless given.  The history holds every tenth step and the last.

``--dryrun`` runs the full config's ``train_4k`` step (every microbatch,
the backward and the AdamW update) for one rank of the 16x16 mesh on the
meta device (``launch/dryrun.py``) and writes its record under
``build/dryrun/single/``; it allocates on no device, and takes minutes.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--local", action="store_true",
                    help="the reduced config")
    ap.add_argument("--dryrun", action="store_true",
                    help="the full config's train cell on the production "
                         "mesh, on the meta device")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dryrun:
        from repro_torch.launch.dryrun import _artifact_dir, run_cell
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
        rec = run_cell(args.arch, "train_4k", "single", mesh, _artifact_dir(),
                       force=True)
        return 0 if rec.get("status") == "ok" else 1

    import tempfile

    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, TrainDataset
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainConfig, ValetCheckpointer, fit

    cfg = reduced(get_arch(args.arch)) if args.local else get_arch(args.arch)
    ctx = T.ParallelCtx(remat=False, q_block=32, kv_block=32, loss_chunk=32,
                        compute_dtype=torch.float32)
    adamw = optim.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       compute_dtype=torch.float32, adamw=adamw)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = T.init_params(cfg, generator=gen, device=args.device)
    ds = TrainDataset(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                 global_batch=args.global_batch))
    ckpt = ValetCheckpointer(args.ckpt_dir or tempfile.mkdtemp(), replicas=2)

    def cb(step, params, opt_state, metrics):
        if step and step % 50 == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})

    params, opt_state, hist = fit(params, cfg, ctx, tcfg, ds,
                                  n_steps=args.steps, callback=cb)
    ckpt.save(args.steps, {"params": params, "opt": opt_state})
    ckpt.close()
    for h in hist:
        print(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
