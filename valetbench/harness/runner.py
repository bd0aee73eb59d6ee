"""One run of one cell: set-up, the window, the traced steps, the check,
the metrics and the result line."""
from __future__ import annotations

import gc
import importlib.util
import time
from typing import Dict, List

import numpy as np
import torch

from valetbench.harness import check
from valetbench import loops
from valetbench.harness.drive import Driver, make_engine, sync
from valetbench.harness.runview import Run
from valetbench.harness.spec import HERE, Cell
from valetbench.harness.trace import Tracer
from valetbench.harness.traffic import Traffic
from valetbench.harness.weights import make_params
from valetbench.harness.work import Model

DEFAULT_TRACE_STEPS = 12


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"valetbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_steps(cell: Cell) -> int:
    steps = [getattr(metric_module(m["name"]), "STEPS", 0) for m in cell.per_layer]
    return max(steps + [0]) or DEFAULT_TRACE_STEPS


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, log=print) -> Dict:
    """Set up, serve, check and read the metrics of one run.  Returns the
    result's fields; on a device other than CUDA no device metric is read
    and ``device`` says so."""
    loop = loops.of(cell.traffic)
    clock = time.perf_counter
    cuda = torch.device(device).type == "cuda"
    marks = [("start", t_start)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.init()
        marks.append(("cuda", clock()))
        from repro_torch.kernels import cuda_lib
        cuda_lib.load()                       # builds into build/kernels/ once
        marks.append(("kernels", clock()))
    params = make_params(cell.config, seed, device)
    sync(device)
    marks.append(("weights", clock()))
    traffic = Traffic(cell.traffic, seed, cell.config["vocab_size"])
    engine = make_engine(params, cell.config, traffic, device)
    sync(device)
    marks.append(("engine", clock()))
    driver = Driver(engine, traffic, clock)
    served = loop.serve(driver, seconds, device,
                        trace_steps=trace_steps(cell) if trace and cuda else 0,
                        tracer=Tracer)
    setup_s = served.window[0] - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else None
    run = Run(cell, served, Model(cell.config), setup_s, served.trace)
    marks.append(("warm-up", served.window[0]))
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                               for a, b in zip(marks, marks[1:])))
    log(summary(run))
    if run.trace is not None:
        for line in trace_summary(run):
            log(line)
    # the port's state goes before the reference runs; the weights stay
    del engine, driver.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rids = check.sample(served, cell.traffic, seed)
    t0 = clock()
    result = check.gaps(params, cell.config, served.objects, rids, device,
                        control=control)
    gap, ctl = result if control else (result, None)
    sync(device)
    reqs = [served.requests[r] for r in rids]
    log(f"check: {len(rids)} requests ({sum(r.done_t is not None for r in reqs)} "
        f"finished), {sum(len(r.token_times) for r in reqs)} served tokens; "
        f"{sum(r.pauses > 0 for r in reqs)} paused, "
        f"{sum(r.resume_at is not None for r in reqs)} resumed, with shares of "
        f"repointed pages " + ", ".join(f"{r.repoint_share:.3g}" for r in reqs
                                        if r.resume_at is not None)
        + f"; reference {clock() - t0:.1f} s; widest gap per request "
        + ", ".join(f"{gap[r]:.4g}" for r in rids))
    correct, failed, checked = check.verdict(served.objects, served.requests, rids,
                                             gap, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = metric_module(m["name"])
        if mod.DEVICE and not cuda:
            log(f"note: {m['name']} is a device metric: not measured on {device}")
            continue
        value = mod.read(run)
        if value is None:
            log(f"note: {m['name']} found nothing to read: null, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(served.requests), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and cuda:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown([s.label() for s in run.traced_steps()])
    if control:
        ctl_correct, _, ctl_checked = check.verdict(served.objects, served.requests,
                                                    rids, ctl, cell.limits)
        out["control"] = {"served_gap": gap, "control_gap": ctl,
                          "correct": ctl_correct, "checked": ctl_checked}
    out["checked"] = checked
    return out


def summary(run: Run) -> str:
    w = run.window_steps()
    walls = sorted(s.wall for s in w)
    return (f"steps: median {1e3 * walls[len(walls) // 2]:.1f} ms, longest "
            f"{1e3 * walls[-1]:.1f} ms; "
            f"record: window {run.window_s:.3f} s, {len(w)} steps, "
            f"{run.count('tokens')} tokens, {sum(len(s.prefills) for s in w)} prefills, "
            f"{run.count('pauses')} pauses, {run.count('restored_pages')} pages restored "
            f"({run.count('streamed_pages')} streamed, {run.count('repointed_pages')} "
            f"repointed), {run.count('flushed_pages')} flushed; set-up {run.setup_s:.3f} s "
            f"over {sum(1 for s in run.served.steps if s.phase == 'warmup')} warm-up steps; "
            f"{len(run.served.requests)} requests submitted, "
            f"{sum(r.done_t is not None for r in run.served.requests.values())} finished")


def trace_summary(run: Run) -> List[str]:
    """What the traced steps did and launched, and what the profiler cost."""
    steps = run.traced_steps()
    found = run.trace.launches(("paged_split", "paged_combine", "flash_tc",
                                "flash_fwd", "ssd_"))
    dec = lambda st: [1e3 * s.wall for s in st if not s.prefills] or [np.nan]
    cost, wall = run.profiler_cost(), run.untraced_wall()
    raw = 1.0 - run.trace.busy_s() / run.trace.window_s
    return [
        f"trace: {len(steps)} steps ({sum(bool(s.decodes) for s in steps)} decoding, "
        f"{sum(len(s.prefills) for s in steps)} prefills) x {run.model.paged_layers} "
        f"paged and {len(run.model.windows)} attention layers; launches "
        + ", ".join(f"{k} {n}" for k, n in found.items()),
        f"trace: decode-only steps' median wall {np.median(dec(steps)):.1f} ms traced, "
        f"{np.median(dec(run.window_steps())):.1f} ms in the window; profiler cost "
        + ("none read" if cost is None else f"{1e6 * cost:.3f} us")
        + f" per device operation over {sum(run.trace.step_ops())}; busy "
        f"{run.trace.busy_s():.4f} s of {run.trace.window_s:.4f} s traced (idle "
        f"{100 * raw:.2f}%), of " + ("none read" if wall is None else
                                     f"{wall:.4f} s unprofiled")
        + "; traced walls (ms) " + ", ".join(f"{1e3 * s.wall:.1f}" for s in steps)]


def check_lines(checked: Dict) -> List[str]:
    return [f"check: {k} {v['value']} limit {v['limit']}" for k, v in checked.items()]
