"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def arch_ids() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {arch_ids()}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {arch_ids()}")
    return importlib.import_module(_MODULES[arch]).smoke()
