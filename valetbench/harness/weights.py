"""The weights, made on the device from the seed in the port's parameter
tree (stacked per run of like layers, the layout ``repro_torch`` reads),
and handed to both the port and the reference.

All bf16 leaves are views of one buffer filled by one ``normal_`` call on
a generator on the device, then scaled in place, one call for each run of
leaves that share a scale (the leaves are laid out by scale).  The SSM's
``A_log``, ``D`` and ``dt_bias`` stay f32, as the port keeps them: views
of one f32 buffer filled by one ``uniform_`` call and mapped in place.

Scales: N(0, 0.02) for matrices, embeddings and the stored norm weights
(the norms scale by 1 + w); output projections (attention ``wo``, FFN
``wd``, SSM ``out_proj``) N(0, 0.02 / sqrt(2 L)); the SSM's conv weights
N(0, 0.5).  A = -exp(A_log) with exp(A_log) uniform in [1, 16], D uniform
in [0.5, 1.5], softplus(dt_bias) uniform in [1e-3, 1e-1].
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from valetbench import reference

ALIGN = 64          # elements: every leaf starts 128-byte aligned in bf16


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def leaf_shapes(config: Dict) -> List[Tuple[tuple, str, tuple, str]]:
    """(path, scale kind, shape, dtype) of every leaf, in tree order: the
    embedding, final norm and unembedding, then each run of like layers as
    the family's reference module lays it out (``run_leaves``)."""
    ref = reference.of(config)
    d, vp = config["hidden_size"], padded_vocab(config["vocab_size"])
    leaves = [(("embed",), "w", (vp, d), "bf16"),
              (("final_ln",), "w", (d,), "bf16"),
              (("unembed",), "w", (d, vp), "bf16")]
    for si, run in enumerate(config["layers"]):
        leaves += ref.run_leaves(config, run, ("segments", si))
    return leaves


SCALE_ORDER = ("w", "out", "conv")
F32_ORDER = ("A_log", "D", "dt_bias")


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _numel(shape) -> int:
    return math.prod(shape)


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def make_params(config: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``config`` from ``seed`` on ``device``."""
    leaves = leaf_shapes(config)
    n_layers = config["num_hidden_layers"]
    scales = {"w": 0.02, "out": 0.02 / math.sqrt(2 * n_layers), "conv": 0.5}
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    tree: Dict = {}
    bf = [lf for kind in SCALE_ORDER for lf in leaves if lf[1] == kind]
    total = sum(_aligned(_numel(lf[2])) for lf in bf)
    flat = torch.empty((total,), dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    off = 0
    for kind in SCALE_ORDER:
        start = off
        for path, k, shape, _ in bf:
            if k != kind:
                continue
            _put(tree, path, flat[off:off + _numel(shape)].view(shape))
            off += _aligned(_numel(shape))
        flat[start:off].mul_(scales[kind])
    f32 = [lf for kind in F32_ORDER for lf in leaves if lf[1] == kind]
    if f32:
        total = sum(_numel(lf[2]) for lf in f32)
        flat32 = torch.empty((total,), dtype=torch.float32, device=device)
        flat32.uniform_(0.0, 1.0, generator=gen)
        off = 0
        for path, kind, shape, _ in f32:
            v = flat32[off:off + _numel(shape)].view(shape)
            off += _numel(shape)
            if kind == "A_log":
                v.mul_(15.0).add_(1.0).log_()
            elif kind == "D":
                v.add_(0.5)
            else:                    # dt_bias = softplus^-1(u), u in [1e-3, 1e-1]
                v.mul_(0.099).add_(0.001).expm1_().log_()
            _put(tree, path, v)
    return tree


def n_params(config: Dict) -> int:
    return sum(_numel(lf[2]) for lf in leaf_shapes(config))
