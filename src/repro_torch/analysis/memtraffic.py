"""Analytic per-rank HBM traffic (the roofline memory term): the port's
copy of ``repro/analysis/memtraffic.py``, with the same coefficients.

The fake pass's "bytes accessed" (``analysis/fake_run.py``) sums the
inputs and outputs of every aten op, which no fused kernel does: it is
kept in the dry-run record as an upper bound, but the roofline's t_mem
uses this analytic model of what a step moves through HBM:

train (per step, per rank):
    weights   : read fwd + read remat + read bwd             3 x P
    grads     : write + read (optimizer)                     2 x P
    optimizer : m,v read+write, p read+write                 4 x M + 2 x P
    activs    : residual-granularity saves r/w (remat=full saves layer inputs
                only; intermediates are recomputed)
    attention : flash re-reads KV once per q-block
decode (per token, per rank):
    weights read once + KV cache read + one-slot write
prefill:
    weights read + fwd activations + cache write + flash KV re-reads

The model errs on the optimistic (fused) side, making t_mem a *lower*
bound: a cell reported memory-bound truly is.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.config.shapes import ShapeConfig

PyTree = Any


def _dtype_bytes(dt) -> float:
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    import numpy as np

    return np.dtype(dt).itemsize


def collective_wire_bytes(kind: str, result_bytes: float,
                          group_size: int) -> float:
    """Ring-model per-rank wire bytes for one collective, from its *result*
    buffer size:

      all-gather         operand * (g-1) = result/g * (g-1)
      reduce-scatter     result * (g-1)
      all-reduce         2 * result * (g-1) / g
      all-to-all         result * (g-1) / g
      collective-permute result                       (point-to-point)
    """
    g = max(int(group_size), 1)
    if kind == "all-gather":
        return result_bytes / g * (g - 1)
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute / unknown


def sharded_bytes(specs: PyTree, axes: PyTree, ctx) -> float:
    """Per-rank bytes of a spec tree (ParamSpecs or tensors, meta ones
    included) under the resolver's placements (``ctx``, a
    :class:`~repro_torch.sharding.rules.ShardingContext` over any
    mesh-like object)."""
    from repro_torch.checkpoint.elastic import _map2
    from repro_torch.sharding.rules import resolve_pspec

    total = 0.0

    def one(leaf, ax):
        nonlocal total
        spec = resolve_pspec(leaf.shape, ax, ctx)
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for n in names:
                denom *= ctx.axis_size(n)
        total += math.prod(leaf.shape) * _dtype_bytes(leaf.dtype) / denom

    _map2(one, specs, axes)
    return total


def _ff_active(cfg: ModelConfig) -> float:
    if cfg.family == "moe":
        return cfg.moe.top_k * cfg.moe.d_ff_expert * cfg.moe.capacity_factor
    if cfg.family == "ssm":
        return 2.0 * cfg.ssm.d_inner(cfg.d_model)
    return float(cfg.d_ff)


def activation_traffic_per_layer(cfg: ModelConfig, tokens_global: int,
                                 chips: int, passes: float) -> float:
    """Per-rank bytes for one layer's activation stream.

    Residual-granularity tensors (written fwd, read bwd): the block input,
    attention output, MLP input, MLP output (4 x d); the MLP hidden and
    attention q/k/v stay on chip in fused kernels (their HBM traffic is
    the remat *recompute*, already counted as weight re-reads).
    """
    t_chip = tokens_global / chips
    d = cfg.d_model
    bytes_bf16 = 2.0
    resident = 4.0 * d + 0.5 * _ff_active(cfg)   # spilled fraction of hidden
    return t_chip * resident * bytes_bf16 * passes


def flash_kv_traffic(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                     chunk: int = 1024) -> float:
    """Flash attention re-reads K,V once per query block (causal ~ 1/2)."""
    if cfg.family == "ssm":
        return 0.0
    s = shape.seq_len
    window = cfg.sliding_window or s
    kv_len = min(s, window)
    n_q_blocks = max(1, s // chunk)
    kv_bytes = (shape.global_batch * kv_len * cfg.num_kv_heads
                * cfg.resolved_head_dim * 2 * 2.0)
    return 0.5 * n_q_blocks * kv_bytes / chips


def hbm_traffic(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                param_bytes_chip: float, moment_bytes_chip: float = 0.0,
                cache_bytes_chip: float = 0.0, remat: bool = True) -> float:
    """Per-rank HBM bytes for one step of this cell."""
    L = cfg.num_layers
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        weight_reads = (3.0 if remat else 2.0) * param_bytes_chip
        grad_traffic = 2.0 * param_bytes_chip
        opt_traffic = 4.0 * moment_bytes_chip + 2.0 * param_bytes_chip
        act = L * activation_traffic_per_layer(cfg, tokens, chips, passes=2.0)
        kv = L * flash_kv_traffic(cfg, shape, chips) * 3.0  # fwd+remat+bwd
        return weight_reads + grad_traffic + opt_traffic + act + kv
    if shape.kind == "prefill":
        act = L * activation_traffic_per_layer(cfg, tokens, chips, passes=1.0)
        kv = L * flash_kv_traffic(cfg, shape, chips)
        return param_bytes_chip + act + kv + cache_bytes_chip  # cache write
    # decode: params + full cache read + one-slot write (~0)
    return param_bytes_chip + cache_bytes_chip
