"""What the traffic asks of the chip, counted from shapes: each kernel
call's operations and bytes, the bound they set on one H100, and the
model FLOPs of served tokens.

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16, 67 TFLOP/s
f32 outside the tensor cores, 3.35 TB/s of HBM.  A call's bound is
max(operations / peak of its dtype, bytes / 3.35 TB/s); bytes count each
input read once and each output written once, at the dtypes the path
serves in.  The counts are those of ``chip_smoke.py``'s kernel cases,
taken over the true lengths of each call (no padding, no masked rows).
"""
from __future__ import annotations

from typing import Dict, Iterable

from valetbench import reference

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEMENT = {"bfloat16": 2, "float32": 4, "int32": 4}


def bound_s(n_bytes: float, n_ops: float, dtype: str):
    """(seconds, "bytes" or "operations") of one call."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[dtype]
    return max(tb, to), ("bytes" if tb >= to else "operations")


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs of causal attention over s positions, within the
    last ``window`` positions when ``window`` > 0."""
    if window <= 0 or s <= window:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def paged_call(lengths: Iterable[int], hq: int, hkv: int, d: int, page: int,
               q_dtype: str, kv_dtype: str):
    """(bytes, ops) of one paged-attention call over rows of KV ``lengths``:
    each row's K and V once, q and out, the rows' block-table entries and
    lengths."""
    lengths = list(lengths)
    live, b = sum(lengths), len(lengths)
    pages = sum(-(-n // page) for n in lengths)
    n_bytes = (2 * live * hkv * d * ELEMENT[kv_dtype]
               + 2 * b * hq * d * ELEMENT[q_dtype] + 4 * pages + 4 * b)
    return n_bytes, 4 * live * hq * d


def flash_call(s: int, hq: int, hkv: int, d: int, window: int, dtype: str):
    """(bytes, ops) of one causal flash-attention call over s positions:
    q, k, v and out once; QK^T and PV over the causal (or banded) pairs."""
    n_bytes = (2 * hq * s + 2 * hkv * s) * d * ELEMENT[dtype]
    return n_bytes, 4 * band_pairs(s, window) * hq * d


def ssd_call(s: int, h: int, p: int, g: int, n: int, chunk: int, dtype: str):
    """(bytes, ops) of one SSD scan over s positions (batch 1): x in
    ``dtype``, dt f32, A, B and C, y f32 and the final state f32 once; the
    chunked algorithm's multiply-adds over chunks of ``chunk`` (the last
    one short): C.B^T per group over the s <= t pairs, the masked matrix
    times x, C.h_prev and the state update."""
    el = ELEMENT[dtype]
    n_bytes = (s * h * p * el + s * h * 4 + h * 4 + 2 * s * g * n * el
               + s * h * p * 4 + h * p * n * 4)
    q = min(chunk, s)
    sizes = [q] * (s // q) + ([s % q] if s % q else [])
    ops = sum(2 * (g * c * (c + 1) // 2 * n + h * c * (c + 1) // 2 * p
                   + 2 * h * c * p * n) for c in sizes)
    return n_bytes, ops


class Model:
    """A configuration's work, layer by layer, as its family's reference
    module states it (``layer_work``): the weights a token multiplies,
    its attention (query heads, KV heads, head size, window; 0 is the
    whole causal prefix), other per-token FLOPs, and an SSD scan's shape."""

    def __init__(self, config: Dict):
        c = config
        self.d, self.vocab = c["hidden_size"], c["vocab_size"]
        self.compute, self.kv = c["dtype"]["compute"], c["dtype"]["kv"]
        ref = reference.of(c)
        self.layers = [ref.layer_work(c, run) for run in c["layers"]
                       for _ in range(run["count"])]
        self.attn = [w["attn"] for w in self.layers if w["attn"]]
        self.scans = [w["ssd"] for w in self.layers if w["ssd"]]

    @property
    def windows(self):
        """Each attention layer's window, in depth order."""
        return [a[3] for a in self.attn]

    @property
    def paged_layers(self) -> int:
        return sum(1 for w in self.windows if w == 0)

    def matmul_params(self) -> int:
        """The weights one token multiplies, over every layer."""
        return sum(w["matmul"] for w in self.layers)

    def _other_flops(self) -> float:
        return sum(w["token_flops"] for w in self.layers)

    def token_flops(self, ctx: int) -> float:
        """FLOPs of one token at position ``ctx - 1`` through every layer
        (no logits): the products with the weights, attention over its
        causal (or windowed) context, and each layer's other work (the
        SSM's conv and recurrence)."""
        f = 2.0 * self.matmul_params()
        f += sum(4.0 * hq * hd * (min(ctx, w) if w else ctx)
                 for hq, _, hd, w in self.attn)
        return f + self._other_flops()

    def prefill_flops(self, s: int) -> float:
        """A first-time prefill of s prompt tokens and its one logits row."""
        f = 2.0 * self.matmul_params() * s
        f += sum(4.0 * hq * hd * band_pairs(s, w) for hq, _, hd, w in self.attn)
        return f + s * self._other_flops() + self.logits_flops()

    def decode_flops(self, kv_len: int) -> float:
        """One decoded token that attends ``kv_len`` positions, with its
        logits row."""
        return self.token_flops(kv_len) + self.logits_flops()

    def logits_flops(self) -> float:
        return 2.0 * self.d * self.vocab

    # kernel bounds of one step -------------------------------------------
    def paged_bound(self, decodes, page: int) -> float:
        """One step's paged calls: every full-attention layer's call over
        the step's decoded rows."""
        if not decodes:
            return 0.0
        return sum(bound_s(*paged_call(decodes, hq, hkv, hd, page, self.compute,
                                       self.kv), self.kv)[0]
                   for hq, hkv, hd, w in self.attn if w == 0)

    def flash_bound(self, prefills) -> float:
        """Every attention layer's flash call of each prefill."""
        return sum(bound_s(*flash_call(s, hq, hkv, hd, w, self.compute),
                           self.compute)[0]
                   for s in prefills for hq, hkv, hd, w in self.attn)

    def ssd_bound(self, prefills) -> float:
        """Every SSM layer's scan of each prefill."""
        return sum(bound_s(*ssd_call(s, *scan, self.compute), self.compute)[0]
                   for s in prefills for scan in self.scans)
