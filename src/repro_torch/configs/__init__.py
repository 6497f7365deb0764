"""Assigned-architecture configs (+ reduced smoke variants)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import arch_ids, get_config, get_smoke_config

__all__ = ["ModelConfig", "arch_ids", "get_config", "get_smoke_config"]
