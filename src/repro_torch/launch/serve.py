"""Serving launcher: the Valet engine over a batch of requests, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --local --requests 8 --policy valet --pool-slots 16

``--local`` serves the reduced config.  The weights are random, made from
seed 0 as the reference's ``PRNGKey(0)``, and the prompts are drawn from
``default_rng(0)``.  The printed lines are the reference's, and the third
ends in what only the port counts: the bytes the engine moved from the
card to the host tier and back (``EngineStats.d2h_bytes``/``h2d_bytes``),
the host arena's pages (``arena=`` in use / capacity, ``peak=`` in use),
the launches of the kernel that moves them (``host_pages=``) and the
dropless MoE's entries and expert groups computed
(``EngineStats.moe_entries``/``moe_groups``: ``moe=`` entries / groups).

``--dryrun`` runs the sharded serve step of ``--shape`` for one rank of
the production mesh on the meta device (``launch/dryrun.py``) and writes
its record under ``build/dryrun/single/``; it allocates on no device.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="valet")
    ap.add_argument("--pool-slots", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dryrun:
        from repro_torch.launch.dryrun import _artifact_dir, run_cell
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
        rec = run_cell(args.arch, args.shape, "single", mesh, _artifact_dir(),
                       force=True)
        return 0 if rec.get("status") == "ok" else 1

    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.policies import POLICIES
    from repro_torch.models import transformer as T
    from repro_torch.serve import ValetServeEngine

    cfg = reduced(get_arch(args.arch)) if args.local else get_arch(args.arch)
    ctx = T.ParallelCtx(remat=False, q_block=16, kv_block=16)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = T.init_params(cfg, generator=gen, device=args.device)
    eng = ValetServeEngine(
        params, cfg, ctx, max_batch=args.max_batch,
        max_seq=args.prompt_len + args.max_new + args.page,
        page=args.page, pool_slots=args.pool_slots,
        policy=POLICIES[args.policy], device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(2, cfg.vocab, size=args.prompt_len),
                   args.max_new)
    from repro_torch.kernels import host_pages as hp
    launches = hp.host_pages.launches
    reqs = eng.run()
    s, arena = eng.stats, eng.arena
    print(f"policy={args.policy} requests={len(reqs)} "
          f"done={sum(r.status == 'done' for r in reqs)} tokens={s.tokens}")
    print(f"steps={s.steps} pauses={s.pauses} spilled={s.spilled_pages} "
          f"restored={s.restored_pages} recomputes={s.recomputes}")
    print(f"sim_time={s.sim_time_us / 1e3:.2f}ms "
          f"bg_time={s.bg_time_us / 1e3:.2f}ms wall={s.wall_time_s:.2f}s "
          f"d2h={s.d2h_bytes / 1e6:.3f}MB h2d={s.h2d_bytes / 1e6:.3f}MB "
          f"arena={arena.in_use}/{arena.capacity} peak={arena.peak} "
          f"host_pages={hp.host_pages.launches - launches} "
          f"moe={s.moe_entries}/{s.moe_groups}")
    for r in reqs[:4]:
        print(f"  req{r.rid}: {r.tokens_out[:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
