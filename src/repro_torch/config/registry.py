"""Architecture registry: ``--arch <id>`` → ModelConfig (the port's copy of
``repro/config/registry.py``; the configs are data, all ten are here).

Both dashed ("mixtral-8x7b") and underscored ("mixtral_8x7b") ids resolve.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.base import ModelConfig

# id → module under repro_torch.configs
_ARCH_MODULES: Dict[str, str] = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-8b": "qwen3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3-405b": "llama3_405b",
    "granite-3-2b": "granite_3_2b",
    "llava-next-34b": "llava_next_34b",
    "mamba2-780m": "mamba2_780m",
    "whisper-base": "whisper_base",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_arch(arch_id: str) -> ModelConfig:
    key = arch_id.strip()
    if key not in _ARCH_MODULES:
        # accept underscore form
        undashed = {v: k for k, v in _ARCH_MODULES.items()}
        if key in undashed:
            key = undashed[key]
        else:
            raise KeyError(f"unknown arch {arch_id!r}; choose from {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    cfg: ModelConfig = mod.CONFIG
    if cfg.name != key:
        raise ValueError(
            f"registry mismatch: repro_torch.configs.{_ARCH_MODULES[key]} declares "
            f"CONFIG.name={cfg.name!r} but is registered under {key!r}")
    return cfg


class _LazyArchDict(dict):
    """Mapping view that imports configs on first access."""

    def __missing__(self, key: str) -> ModelConfig:
        cfg = get_arch(key)
        self[key] = cfg
        return cfg

    def keys(self):  # type: ignore[override]
        return _ARCH_MODULES.keys()


ARCHS: Dict[str, ModelConfig] = _LazyArchDict()
