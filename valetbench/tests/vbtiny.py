"""Cells of the benchmark cut to a CPU test's size: the configuration and
traffic files of a real cell with their widths, depth and lengths cut, the
metrics of BENCHMARK.json, and a limit for the tiny model."""
from __future__ import annotations

import copy
import time

from valetbench.harness.spec import HERE, ROOT, Cell, load_json, metrics_for

# widest gap of served tokens at these sizes: sound runs read at most
# ~2e-3 (bf16 against the f32 reference); a fault reads 0.05 and more
TINY_LIMIT = 0.02


def tiny_config(name: str, width: int = 64, vocab: int = 300) -> dict:
    c = copy.deepcopy(load_json(HERE / "configs" / f"{name}.json"))
    heads, hd = 4, width // 4
    c.update(hidden_size=width, num_attention_heads=heads, num_key_value_heads=2,
             head_dim=hd, intermediate_size=2 * width, vocab_size=vocab)
    p = c["port"]
    p.update(d_model=width, n_heads=heads, n_kv_heads=2, head_dim=hd,
             d_ff=2 * width, vocab=vocab)
    if "mamba_d_state" in c:
        c.update(num_hidden_layers=6, sliding_window=16, global_attn_idx=[0, 2, 5],
                 mamba_d_state=8, mamba_head_dim=16, mamba_chunk_size=8)
        c["layers"] = [{"kind": "hybrid", "count": n, "window": w}
                       for n, w in ((1, 0), (1, 16), (1, 0), (2, 16), (1, 0))]
        p.update(n_layers=6, window=16, global_every=3)
        p["ssm"].update(d_state=8, head_dim=16, chunk_size=8)
    else:
        c.update(num_hidden_layers=2)
        c["layers"] = [{"kind": "attn", "count": 2, "window": 0}]
        p.update(n_layers=2)
    return c


def tiny_traffic(name: str) -> dict:
    t = copy.deepcopy(load_json(HERE / "traffic" / f"{name}.json"))
    t.update(clients=8, max_batch=8, warmup_steps=4)
    t["prompt"] = ({"min": 8, "max": 40} if t["prompt"]["min"] < 1000
                   else {"min": 20, "max": 60})
    t["output"] = {"min": 4, "max": 16}
    return t


def tiny_cell(workload: str, limit: float = TINY_LIMIT, **cfg_kw) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    w = [x for x in bench["workloads"] if x["name"] == workload][0]
    return Cell(workload, w, tiny_config(w["config"], **cfg_kw),
                tiny_traffic(w["traffic"]), {"max_logit_gap": {"limit": limit}},
                metrics_for(bench["end_to_end"], workload),
                metrics_for(bench["per_layer"], workload))


def rehearse(cell: Cell, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
             control: bool = False, trace: bool = False) -> dict:
    from valetbench.harness.runner import run_cell
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    control=control, log=lambda *a: None)
