"""Configs of the port: model, parallel, train and run dataclasses and the
``--arch`` registry."""
from repro_torch.config.base import (
    EncDecConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    RunConfig,
    SSMConfig,
    TrainConfig,
)
from repro_torch.config.registry import ARCHS, get_arch, list_archs

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "HybridConfig",
    "EncDecConfig",
    "ParallelConfig",
    "TrainConfig",
    "RunConfig",
    "ARCHS",
    "get_arch",
    "list_archs",
]
