"""Model configs of the port: dataclasses and the ``--arch`` registry."""
from repro_torch.config.base import (
    EncDecConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.config.registry import ARCHS, get_arch, list_archs

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "HybridConfig",
    "EncDecConfig",
    "ARCHS",
    "get_arch",
    "list_archs",
]
