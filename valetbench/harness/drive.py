"""The port's ``ValetServeEngine`` driven through its public calls
(``submit``, ``step``) with a wall-clock stamp after each ``step()``, and
what the benchmark records of it.  When to submit and step is the
traffic's loop (``valetbench/loops/<kind>.py``).

Each ``step()`` ends in a device-to-host copy of the step's argmax, so a
token's time is the end of the step that produced it.  The harness keeps,
for every request it submitted, the ``Request`` object the engine made for
it (``engine._requests[rid]``, read once after ``submit``), and reads its
public fields (``status``, ``prompt``, ``tokens_out``) after each step.  It
patches nothing in the port.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from valetbench.harness.traffic import Traffic

COUNTERS = ("tokens", "pauses", "restored_pages", "streamed_pages",
            "repointed_pages", "recomputes", "flushed_pages")


@dataclass
class StepRec:
    index: int
    t0: float
    t1: float
    counts: Dict[str, int]          # EngineStats deltas over the step
    prefills: List[int]             # prompt lengths prefilled for the first time
    decodes: List[int]              # KV length each decoded row attended
    phase: str                      # "warmup", "window" or "after"

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def label(self) -> str:
        """What the step did, for the trace's idle gaps."""
        parts = [f"{len(self.decodes)} decodes"]
        if self.prefills:
            parts.append(f"{len(self.prefills)} prefills")
        if self.counts["pauses"]:
            parts.append("pauses")
        if self.counts["streamed_pages"]:
            parts.append("stream-in")
        return "step: " + ", ".join(parts)


@dataclass
class ReqRec:
    index: int
    rid: int
    prompt_len: int
    max_new: int
    token_times: List[float] = field(default_factory=list)
    pauses: int = 0
    resume_at: Optional[int] = None  # tokens served before its first resume
    repoint_share: float = 0.0      # its share of the repointed pages of the
                                    # steps it resumed in (split evenly)
    done_t: Optional[float] = None


@dataclass
class Served:
    """What one run recorded."""
    steps: List[StepRec]
    requests: Dict[int, ReqRec]     # by rid
    objects: Dict[int, object]      # rid -> the engine's Request
    window: tuple                   # (start, end) on the harness clock
    profiled: List[int] = field(default_factory=list)   # step indices traced
    trace: object = None            # the traced steps' TraceData


def port_arch(config: Dict):
    """The port's ``ArchConfig`` of a configuration file's ``port`` block."""
    from repro_torch.configs.base import ArchConfig, SSMConfig
    kw = dict(config["port"])
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ArchConfig(name=config["name"], **kw)


def check_layout(config: Dict, arch) -> None:
    """The port's runs of layers must be the configuration's ``layers``:
    the weights are laid out by the latter."""
    from repro_torch.models.transformer import segments
    got = [(s.kind, s.count, s.window) for s in segments(arch)]
    want = [(r["kind"], r["count"], r["window"]) for r in config["layers"]]
    if got != want:
        raise RuntimeError(f"the port lays out {got}, the configuration {want}")


def make_engine(params, config: Dict, traffic: Traffic, device):
    from repro_torch.core.policies import POLICIES
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.serve import ValetServeEngine
    arch = port_arch(config)
    check_layout(config, arch)
    compute = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config["dtype"]["compute"]]
    ctx = ParallelCtx(remat=False, compute_dtype=compute)
    spec = traffic.spec
    return ValetServeEngine(params, arch, ctx, max_batch=int(spec["max_batch"]),
                            max_seq=traffic.max_seq, page=int(spec["page"]),
                            pool_slots=traffic.pool_slots(),
                            policy=POLICIES["valet"], zero_restore=True,
                            device=device)


class Driver:
    """Steps an engine and records what each step did."""

    def __init__(self, engine, traffic: Traffic, clock: Callable[[], float]):
        self.eng = engine
        self.traffic = traffic
        self.clock = clock
        self.steps: List[StepRec] = []
        self.requests: Dict[int, ReqRec] = {}
        self.objects: Dict[int, object] = {}
        self.live: List[int] = []          # rids submitted and not done

    def submit(self) -> int:
        r = self.traffic.next_request()
        rid = self.eng.submit(r.prompt, max_new=r.max_new)
        self.objects[rid] = self.eng._requests[rid]
        self.requests[rid] = ReqRec(r.index, rid, len(r.prompt), r.max_new)
        self.live.append(rid)
        return rid

    def step(self, phase: str, scope=None) -> StepRec:
        before = {rid: (self.objects[rid].status, len(self.objects[rid].tokens_out))
                  for rid in self.live}
        st = self.eng.stats
        c0 = {k: getattr(st, k) for k in COUNTERS}
        t0 = self.clock()
        with scope or nullcontext():
            self.eng.step()
        t1 = self.clock()
        counts = {k: getattr(st, k) - c0[k] for k in COUNTERS}
        prefills, decodes, still = [], [], []
        resumed = [rid for rid in self.live if before[rid][0] == "paused"
                   and self.objects[rid].status not in ("paused", "waiting")]
        for rid in resumed:
            rec = self.requests[rid]
            if rec.resume_at is None:
                rec.resume_at = before[rid][1]
            rec.repoint_share += counts["repointed_pages"] / len(resumed)
        for rid in self.live:
            obj, rec = self.objects[rid], self.requests[rid]
            status0, n0 = before[rid]
            n1 = len(obj.tokens_out)
            admitted = status0 == "waiting" and obj.status != "waiting"
            if admitted:
                prefills.append(rec.prompt_len)
            if obj.status == "paused" and status0 != "paused":
                rec.pauses += 1
            n_dec = n1 - n0 - (1 if admitted else 0)
            for j in range(n_dec):
                decodes.append(rec.prompt_len + n0 + (1 if admitted else 0) + j)
            rec.token_times += [t1] * (n1 - n0)
            if obj.status == "done":
                rec.done_t = t1
            else:
                still.append(rid)
        self.live = still
        rec = StepRec(len(self.steps), t0, t1, counts, prefills, decodes, phase)
        self.steps.append(rec)
        return rec


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
