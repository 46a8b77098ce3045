"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each assigned architecture lives in its own module with the exact public
config (FULL) and a reduced same-family smoke config (SMOKE).
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_67b,
    granite_34b,
    granite_8b,
    granite_moe_3b,
    hubert_xlarge,
    mamba2_370m,
    phi3_5_moe,
    phi3_vision,
    qwen1_5_0_5b,
    zamba2_7b,
)
from repro_torch.configs.shapes import SHAPES, cells_for, input_specs, runnable

_MODULES = {
    "zamba2-7b": zamba2_7b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe,
    "granite-moe-3b-a800m": granite_moe_3b,
    "hubert-xlarge": hubert_xlarge,
    "deepseek-67b": deepseek_67b,
    "granite-8b": granite_8b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "granite-34b": granite_34b,
    "mamba2-370m": mamba2_370m,
    "phi-3-vision-4.2b": phi3_vision,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) pair."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        out.extend((a, s) for s in cells_for(cfg))
    return out
