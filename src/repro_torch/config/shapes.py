"""The input-shape set of the cells (the same four shapes for every
LM-family arch): the port's copy of ``repro/config/shapes.py``.

``decode_*`` / ``long_*`` build the decode cell (one new token against a
KV cache of ``seq_len``), not the train step. ``long_500k`` needs
sub-quadratic attention and is skipped for pure full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768,
                               global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768,
                              global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                             kind="decode"),
}


def shape_by_name(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; choose from "
                       f"{sorted(SHAPES)}") from None


def cell_is_runnable(model_subquadratic: bool, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic archs (SWA / SSM / hybrid)."""
    if shape.name == "long_500k":
        return model_subquadratic
    return True
