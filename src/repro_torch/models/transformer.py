"""Layer stacks: the port of ``repro/models/transformer.py`` for dense
attention models.

A stack runs :func:`layer_apply` either over a scanned layout (every leaf
stacked with a leading layer dim, as ``lax.scan`` takes it in the JAX
package) or over an unrolled list of per-layer trees; here both are a Python
loop. Block kinds other than ``"attn"`` (MoE, SSM, RG-LRU, encoder-decoder)
wait for their slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamSpec,
    ParamTree,
    mlp_apply,
    mlp_specs,
    rms_norm,
)



def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet; see ROADMAP.md (Queue 1 and "
        f"the next slices)")


# ------------------------------------------------------------------ block map
def block_kinds(cfg: ModelConfig) -> List[str]:
    """Per-layer temporal-mixing kind."""
    if cfg.family in ("dense", "vlm"):
        return ["attn"] * cfg.num_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        return [("local_attn" if pat[i % len(pat)] == "attn" else "rglru")
                for i in range(cfg.num_layers)]
    if cfg.family == "encdec":
        return ["decoder"] * cfg.num_layers
    raise ValueError(cfg.family)


def uniform_stack(cfg: ModelConfig) -> bool:
    kinds = block_kinds(cfg)
    return all(k == kinds[0] for k in kinds) and cfg.family != "encdec"


# ---------------------------------------------------------------------- specs
def _norm_specs(cfg: ModelConfig, name: str) -> Dict[str, ParamSpec]:
    return {name: ParamSpec((cfg.d_model,), torch.float32, "ones")}


def layer_specs(cfg: ModelConfig, kind: str,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    if kind != "attn":
        raise _not_ported(f"block kind {kind!r}")
    s: Dict[str, Any] = {}
    s.update(_norm_specs(cfg, "norm1"))
    s["attn"] = attn.attention_specs(cfg, dtype)
    s.update(_norm_specs(cfg, "norm2"))
    s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, dtype)
    return s


# ---------------------------------------------------------------------- apply
def layer_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, mode: str, cache, pos,
                attn_impl: str):
    """One block, `mode` "train" (full sequence, no cache), "prefill" or
    "decode". Returns (x, cache), the cache updated in place."""
    if kind != "attn":
        raise _not_ported(f"block kind {kind!r}")
    window = cfg.sliding_window
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mode == "train":
        y = attn.self_attention(p["attn"], h, cfg, positions, causal=True,
                                impl=attn_impl, window=window)
    elif mode == "prefill":
        y, cache = attn.prefill_attention(p["attn"], h, cfg, positions, cache,
                                          impl=attn_impl, window=window)
    elif mode == "decode":
        y, cache = attn.decode_attention(p["attn"], h, cfg, cache, pos,
                                         window=window)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h), cache


# ----------------------------------------------------------------- the stacks
def _stacked(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, spec.dtype, spec.init, spec.scale)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_specs(cfg: ModelConfig, scan: bool, dtype=torch.bfloat16) -> Any:
    """Specs of the main stack: one tree with a leading layer dim on every
    leaf (scanned) or a list of per-layer trees (unrolled)."""
    kinds = block_kinds(cfg)
    if scan and uniform_stack(cfg):
        one = layer_specs(cfg, kinds[0], dtype)
        return _map_specs(lambda s: _stacked(s, cfg.num_layers), one)
    return [layer_specs(cfg, k, dtype) for k in kinds]


def _layer(tree, i: int):
    """Layer i of a scanned tree: views of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, ParamTree):
        return {k: _layer(v, i)
                for k, v in {**tree._parameters, **tree._modules}.items()}
    return tree[i]


def is_unrolled(layers) -> bool:
    return isinstance(layers, (list, tuple, nn.ModuleList))


def stack_apply(params, x, cfg: ModelConfig, positions, mode: str, caches,
                pos, attn_impl: str):
    """Run the full stack. `params` matches :func:`stack_specs`' layout
    (stacked tree for scan, list for unrolled), `caches` that of
    :func:`stack_cache_specs` (or None in "train" mode). The caches are
    written in place through per-layer views. Returns (x, caches)."""
    kinds = block_kinds(cfg)
    unrolled = is_unrolled(params)
    for i, kind in enumerate(kinds):
        p_l = params[i] if unrolled else _layer(params, i)
        cache_l = None
        if caches is not None:
            cache_l = caches[i] if is_unrolled(caches) else _layer(caches, i)
        x, _ = layer_apply(p_l, x, cfg, kind, positions, mode, cache_l, pos,
                           attn_impl)
    return x, caches


# ------------------------------------------------------------- cache builders
def stack_cache_specs(cfg: ModelConfig, batch: int, max_len: int, scan: bool,
                      dtype=torch.bfloat16):
    """ParamSpec tree for the per-layer decode caches."""
    kinds = block_kinds(cfg)

    def one(kind: str):
        if kind != "attn":
            raise _not_ported(f"the decode cache of block kind {kind!r}")
        w = max_len
        if cfg.sliding_window is not None:
            w = min(max_len, cfg.sliding_window)
        return attn.cache_specs(cfg, batch, w, dtype)

    if scan and uniform_stack(cfg):
        return _map_specs(lambda s: _stacked(s, cfg.num_layers),
                          one(kinds[0]))
    return [one(k) for k in kinds]
