"""Config registry: ``get_arch(name)``, ``ARCHS``, ``SHAPES``."""
from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, ShapeConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    shape_applicable, reduced, replace,
)

from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.qwen2_moe_a27b import CONFIG as _qwen2
from repro_torch.configs.mamba2_27b import CONFIG as _mamba2
from repro_torch.configs.hymba_15b import CONFIG as _hymba
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.phi3_mini_38b import CONFIG as _phi3
from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.llama32_vision_11b import CONFIG as _llama_vision
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper

ARCHS = {
    c.name: c
    for c in (
        _deepseek, _qwen2, _mamba2, _hymba, _gemma3,
        _phi3, _granite, _danube, _llama_vision, _whisper,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Yield every (arch, shape, applicable, skip_reason) cell — 40 total."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape)
            yield arch, shape, ok, why
