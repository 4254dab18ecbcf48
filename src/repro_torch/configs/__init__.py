"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full (paper-exact) config;
``get_reduced(arch_id)`` returns the CPU smoke-test variant of the family.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = (
    "gemma2_9b",
    "phi3_medium_14b",
    "zamba2_1p2b",
    "mamba2_2p7b",
    "chameleon_34b",
    "llama4_maverick_400b_a17b",
    "seamless_m4t_medium",
    "grok1_314b",
    "minitron_8b",
    "gemma3_27b",
    "qwen_1p5b",  # the paper's own evaluation family (DeepSeek-R1-Distill-Qwen)
)

_ALIASES = {
    "gemma2-9b": "gemma2_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "chameleon-34b": "chameleon_34b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "grok-1-314b": "grok1_314b",
    "minitron-8b": "minitron_8b",
    "gemma3-27b": "gemma3_27b",
    "qwen-1.5b": "qwen_1p5b",
}


def canonical(arch_id: str) -> str:
    key = _ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    return key


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)
