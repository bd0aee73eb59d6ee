"""Whether what the timed path served is right.

Once the window has closed and the port's state is freed, a sample of the
requests the run finished, drawn from the seed, is served again by the
plain reference (``valetbench/reference``): one forward over each prompt
with its served tokens.  At each served position the gap is the
reference's best logit minus its logit of the served token; the number
compared is the widest gap over the sample (``max_logit_gap``).  A token
the reference also ranks first reads 0.

The sample holds the longest finished request, then finished requests in
an order drawn from the seed, paused ones first, until it holds
``sample.tokens`` served tokens or ``sample.requests`` requests.  Few
paused requests finish in a window, so it then takes requests that were
paused and have served tokens since they resumed, finished or not, until
``sample.resumed`` of its requests are such (where the run has that
many): their pages and per-slot state went through the device and host
tiers and back.  Of those it takes first the ones with the largest share
of the repointed pages of the steps they resumed in (the counters are the
step's, so a step's repointed pages are split evenly over the requests it
resumed).  A finished request must have all its tokens; an unfinished
one is compared over the tokens it has.

The control (``gaps(..., control=True)``) is the reference in fp8: at each position of
the same prompts and tokens, the gap of the token that fp8 ranks first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from valetbench import reference
from valetbench.reference.common import fp8, strict_f32


def sample(served, spec: Dict, seed: int) -> List[int]:
    reqs = served.requests
    done = [rid for rid, r in reqs.items() if r.done_t is not None]
    if not done:
        return []
    size = lambda rid: reqs[rid].prompt_len + reqs[rid].max_new
    first = max(done, key=lambda rid: (size(rid), -rid))
    rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
    keys = list(reqs)
    order = [keys[i] for i in rng.permutation(len(keys))]
    rest = [rid for rid in order if rid in done and rid != first]
    rest.sort(key=lambda rid: reqs[rid].pauses == 0)          # stable
    want = spec["sample"]
    out, n_tok = [first], reqs[first].max_new
    for rid in rest:
        if n_tok >= want["tokens"] or len(out) >= want["requests"]:
            break
        out.append(rid)
        n_tok += reqs[rid].max_new
    resumed = lambda rid: (reqs[rid].resume_at is not None
                           and len(reqs[rid].token_times) > reqs[rid].resume_at)
    more = sorted((rid for rid in order if resumed(rid) and rid not in out),
                  key=lambda rid: -reqs[rid].repoint_share)  # stable
    return out + more[:max(0, want.get("resumed", 0) - sum(map(resumed, out)))]


def _sequence(obj, device):
    prompt = np.asarray(obj.prompt, np.int64)
    out = np.asarray(obj.tokens_out, np.int64)
    toks = torch.from_numpy(np.concatenate([prompt, out[:-1]])).to(device)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out), device=device)
    return toks, rows, torch.from_numpy(out).to(device)


@torch.no_grad()
def gaps(params, config, objects, rids, device, control=False):
    """Per request, the widest gap of its served tokens; with ``control``
    also (as a second dict) the widest gap of the tokens that the fp8
    reference ranks first at the same positions."""
    strict_f32()
    ref = reference.of(config)
    served_gap, control_gap = {}, {}
    for rid in rids:
        toks, rows, served = _sequence(objects[rid], device)
        exact = ref.forward(params, config, toks, rows)
        best = exact.max(dim=-1).values
        got = exact.gather(1, served[:, None])[:, 0]
        served_gap[rid] = float((best - got).max())
        if control:
            pick = ref.forward(params, config, toks, rows, lowp=fp8).argmax(dim=-1)
            low = exact.gather(1, pick[:, None])[:, 0]
            control_gap[rid] = float((best - low).max())
        del exact
    return (served_gap, control_gap) if control else served_gap


def verdict(objects, requests, rids, gap_by_rid, limits: Dict):
    """(correct, failed, checked): every sampled request that finished has
    all its tokens, and every sampled request's widest gap is within the
    limit."""
    limit = limits.get("max_logit_gap", {}).get("limit")
    widest = max(gap_by_rid.values()) if gap_by_rid else None
    short = lambda rid: (requests[rid].done_t is not None
                         and len(objects[rid].tokens_out) != requests[rid].max_new)
    failed = sum(1 for rid in rids
                 if short(rid) or limit is None or gap_by_rid[rid] > limit)
    correct = bool(rids) and limit is not None and failed == 0
    checked = {"max_logit_gap": {"value": widest, "limit": limit},
               "sampled_requests": {"value": len(rids),
                                    "limit": "at least 1"}}
    return correct, failed, checked
