"""Architecture registry: one module per assigned architecture (the
same ten configurations as ``repro.configs``)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "deepseek_v2_236b",
    "qwen2_moe_a2_7b",
    "qwen3_14b",
    "olmo_1b",
    "gemma_7b",
    "deepseek_7b",
    "zamba2_2_7b",
    "mamba2_1_3b",
    "llama_3_2_vision_90b",
    "musicgen_medium",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ArchConfig:
    arch = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
