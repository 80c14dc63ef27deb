"""Layer stacks: the port of ``repro/models/transformer.py`` for dense
attention models (kind ``"attn"``, also the VLM backbone and Whisper's
encoder layers), mixtures of experts (``"attn_moe"``: attention, then
:mod:`repro_torch.models.moe` in place of the MLP), Mamba-2 (``"ssm"``),
RecurrentGemma (``"rglru"`` and ``"local_attn"``) and the encoder-decoder's
decoder (``"decoder"``: self-attention, then cross-attention over the
encoder's output, then the MLP; LayerNorm with bias in the whole family).

A stack runs :func:`layer_apply` either over a scanned layout (every leaf
stacked with a leading layer dim, as ``lax.scan`` takes it in the JAX
package) or over an unrolled list of per-layer trees; here both are a Python
loop. A hybrid or encoder-decoder stack is never uniform, so it is always
unrolled. In "train" mode a scanned stack is unbound into its layers once
per call (so its stacked gradient is assembled once, when layer 0's
backward ends), and
``remat="full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` does); ``remat="dots"``
keeps the outputs of the layer's projections and recomputes the rest
(:func:`_dots_policy`). A block returns
its MoE aux loss (None for the other kinds) and the stack sums it over
the layers, as the reference's scan carry does.

Decode caches are written in place through per-layer views (of the stacked
tensors, in the scanned layout): the attention rings by the attention
code, the recurrent state (``h``/``conv``, ``state``/``conv_*``) here,
copied from what the block returns; a decoder layer's prefill puts the
cross-attention keys and values (``cross_k``, ``cross_v``) into its cache
dict as the encoder gave them, and decode reads them unchanged. The JAX
package returns new cache trees instead.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamSpec,
    ParamTree,
    layer_norm,
    map_specs,
    mlp_apply,
    mlp_specs,
    projecting,
    rms_norm,
    tag_layer,
)
from repro_torch.runtime.tracing import layer_span

PORTED_KINDS = ("attn", "attn_moe", "local_attn", "ssm", "rglru", "decoder")
ATTN_KINDS = ("attn", "attn_moe", "local_attn", "decoder")


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
    if cfg.family == "encdec":   # Whisper's LayerNorm, with a bias
        return {name: ParamSpec((cfg.d_model,), (None,), torch.float32,
                                "ones"),
                name + "_b": ParamSpec((cfg.d_model,), (None,), torch.float32,
                                       "zeros")}
    return {name: ParamSpec((cfg.d_model,), (None,), torch.float32, "ones")}


def _norm(p, x, cfg: ModelConfig, name: str) -> torch.Tensor:
    if cfg.family == "encdec":
        return layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)
    return rms_norm(x, p[name], cfg.norm_eps)


def layer_specs(cfg: ModelConfig, kind: str,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    if kind not in PORTED_KINDS:
        raise _not_ported(f"block kind {kind!r}")
    s: Dict[str, Any] = {}
    s.update(_norm_specs(cfg, "norm1"))
    if kind == "ssm":
        s["ssm"] = ssm_mod.ssm_specs(cfg, dtype)
        return s  # the Mamba-2 block has no separate MLP
    if kind == "rglru":
        s["rglru"] = rglru_mod.rglru_specs(cfg, dtype)
    else:
        s["attn"] = attn.attention_specs(cfg, dtype)
    if kind == "decoder":
        s.update(_norm_specs(cfg, "norm_cross"))
        s["cross"] = attn.cross_attention_specs(cfg, dtype)
    s.update(_norm_specs(cfg, "norm2"))
    if kind == "attn_moe":
        s["moe"] = moe_mod.moe_specs(cfg, dtype)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, dtype)
    return s


# ---------------------------------------------------------------------- apply
def layer_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, mode: str, cache, pos,
                attn_impl: str, mesh=None, enc_out=None, tp=None,
                a2a_chunks: int = 1):
    """One block, `mode` "train" (full sequence, no cache), "prefill" or
    "decode". `mesh` and `a2a_chunks` (the over-decomposition of the
    expert-parallel all-to-alls) reach an "attn_moe" block's
    :func:`~repro_torch.models.moe.moe_apply`; `enc_out` (train and
    prefill) is the encoder's output a "decoder" block cross-attends to
    (decode reads its keys and values from the cache). Returns (x, cache,
    aux), the cache updated in place, aux the block's f32 MoE aux loss
    (None for the other kinds).

    `tp` (a :class:`~repro_torch.sharding.tp.TPCut`; in "train" mode
    every kind): `x` is this rank's rows and `p` its blocks. Each norm
    runs on the rows; the mixers (:func:`~repro_torch.models.attention.
    self_attention_tp`, :func:`~repro_torch.models.attention.
    cross_attention_tp` over the whole `enc_out`, :func:`~repro_torch.
    models.ssm.ssm_train_tp`, :func:`~repro_torch.models.rglru.
    rglru_train_tp`) and the MLP gather the rows over the "model" axis,
    compute with the rank's heads or columns and reduce-scatter back to
    the rows (or take them, where the rules replicate); the MoE block
    routes the rows under expert parallelism (:func:`~repro_torch.models.
    moe.moe_apply_tp`). In "prefill" and "decode" (the serving cells; `tp`
    a :class:`~repro_torch.sharding.tp.ServeCut`, every kind) see
    :func:`_layer_serve`."""
    if kind not in PORTED_KINDS:
        raise _not_ported(f"block kind {kind!r}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    aux = None
    h = _norm(p, x, cfg, "norm1")
    if tp is not None:
        if mode != "train":
            return (_layer_serve(p, x, h, cfg, kind, tp, mode, cache, pos,
                                 attn_impl, enc_out, a2a_chunks), cache, aux)
        x, aux = _layer_tp(p, x, h, cfg, kind, tp, enc_out, a2a_chunks,
                           attn_impl)
        return x, cache, aux
    if kind in ("ssm", "rglru"):
        y, cache = _recurrent(p, h, cfg, kind, mode, cache)
        x = x + y
        if kind == "ssm":
            return x, cache, aux
        h = _norm(p, x, cfg, "norm2")
        return x + mlp_apply(p["mlp"], h), cache, aux
    window = (cfg.hybrid.local_window if kind == "local_attn"
              else cfg.sliding_window)
    self_cache = cache["self"] if kind == "decoder" and cache else cache
    if mode == "train":
        y = attn.self_attention(p["attn"], h, cfg, positions, causal=True,
                                impl=attn_impl, window=window)
    elif mode == "prefill":
        y, _ = attn.prefill_attention(p["attn"], h, cfg, positions,
                                      self_cache, impl=attn_impl,
                                      window=window)
    elif mode == "decode":
        y, _ = attn.decode_attention(p["attn"], h, cfg, self_cache, pos,
                                     window=window)
    x = x + y
    if kind == "decoder":
        h = _norm(p, x, cfg, "norm_cross")
        if mode == "decode":
            kv = (cache["cross_k"], cache["cross_v"])
        else:
            kv = attn.encode_cross_kv(p["cross"], enc_out, cfg)
            if mode == "prefill":
                cache["cross_k"], cache["cross_v"] = kv
        x = x + attn.cross_attention(p["cross"], h, kv, cfg)
    h = _norm(p, x, cfg, "norm2")
    if kind == "attn_moe":
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg, mesh, a2a_chunks)
        return x + y, cache, aux
    return x + mlp_apply(p["mlp"], h), cache, aux


def _layer_tp(p, x, h, cfg: ModelConfig, kind: str, tp, enc_out,
              a2a_chunks: int, attn_impl: str):
    """A block's train forward under the tensor-parallel cut: `x` its
    input rows and `h` their first norm, self-attention through
    `attn_impl` ("dense" or "blockwise"). Returns (the output rows, the
    MoE aux loss or None)."""
    if kind == "ssm":
        return x + ssm_mod.ssm_train_tp(p["ssm"], h, cfg, tp), None
    if kind == "rglru":
        x = x + rglru_mod.rglru_train_tp(p["rglru"], h, cfg, tp)
    else:
        window = (cfg.hybrid.local_window if kind == "local_attn"
                  else cfg.sliding_window)
        x = x + attn.self_attention_tp(p["attn"], h, cfg, tp, window,
                                       attn_impl)
    if kind == "decoder":
        h = _norm(p, x, cfg, "norm_cross")
        x = x + attn.cross_attention_tp(p["cross"], h, enc_out, cfg, tp)
    h = _norm(p, x, cfg, "norm2")
    if kind == "attn_moe":
        y, aux = moe_mod.moe_apply_tp(p["moe"], h, cfg, tp, a2a_chunks)
        return x + y, aux
    return x + tp.leave(mlp_apply(p["mlp"], tp.gather_seq(h)), tp.mlp), None


def _layer_serve(p, x, h, cfg: ModelConfig, kind: str, tp, mode: str,
                 cache, pos, attn_impl: str, enc_out, a2a_chunks: int):
    """A block of the serving cells under the cut (`tp`, a
    :class:`~repro_torch.sharding.tp.ServeCut`), `h` the first norm of
    `x`. "prefill": `x` is this rank's (b, s/tp, d) rows, as in
    training; the mixers and the MLP gather the rows, compute with the
    rank's heads or columns (the flash kernel through `attn_impl`, the
    scans' kernels) and reduce-scatter back, and the block's cache is
    written on the rank's block of it. "decode": `x` (b, 1, d) is whole
    on every rank; each mixer and the MLP compute with the rank's heads
    or columns and all-reduce their partial sums; the attention ring
    takes the sharded flash-decode over its slot block. The MoE block
    routes under expert parallelism (:func:`~repro_torch.models.moe.
    moe_apply_cut`, its all-to-alls chunked `a2a_chunks` ways). Returns
    the block's output; the cache is updated in place."""
    prefill = mode == "prefill"
    if kind in ("ssm", "rglru"):
        p_k = p[kind]
        if kind == "ssm":
            y, new = (ssm_mod.ssm_prefill_tp(p_k, h, cfg, tp) if prefill
                      else ssm_mod.ssm_decode_tp(p_k, h, cfg, tp, cache))
        else:
            y, new = (rglru_mod.rglru_prefill_tp(p_k, h, cfg, tp) if prefill
                      else rglru_mod.rglru_decode_tp(p_k, h, cfg, tp, cache))
        for k, val in new.items():
            cache[k].copy_(val)
        x = x + y
        if kind == "ssm":
            return x
        return x + _mlp_serve(p["mlp"], _norm(p, x, cfg, "norm2"), tp, mode)
    window = (cfg.hybrid.local_window if kind == "local_attn"
              else cfg.sliding_window)
    self_cache = cache["self"] if kind == "decoder" else cache
    ring = tp.ring(ring_len(cfg, kind, tp.max_len))
    if prefill:
        y = attn.prefill_attention_tp(p["attn"], h, cfg, self_cache, tp,
                                      ring, attn_impl, window)
    else:
        y = attn.decode_attention_tp(p["attn"], h, cfg, self_cache, pos, tp,
                                     ring, window)
    x = x + y
    if kind == "decoder":
        h = _norm(p, x, cfg, "norm_cross")
        if prefill:
            x = x + attn.cross_attention_tp(p["cross"], h, enc_out, cfg, tp,
                                            cache=cache)
        else:
            x = x + attn.cross_attention_decode_tp(
                p["cross"], h, (cache["cross_k"], cache["cross_v"]), cfg, tp)
    h = _norm(p, x, cfg, "norm2")
    if kind == "attn_moe":
        return x + moe_mod.moe_apply_cut(p["moe"], h, cfg, tp, mode,
                                         a2a_chunks)
    return x + _mlp_serve(p["mlp"], h, tp, mode)


def _mlp_serve(p, h, tp, mode: str) -> torch.Tensor:
    """The MLP on the rank's ``d_ff`` columns: on the gathered rows, its
    partial sums reduce-scattered back ("prefill"), or on the whole
    token, all-reduced ("decode")."""
    if mode == "prefill":
        return tp.leave(mlp_apply(p, tp.gather_seq(h)), tp.mlp)
    y = mlp_apply(p, h)
    return tp.all_reduce(y) if tp.mlp else y


def _recurrent(p, h, cfg: ModelConfig, kind: str, mode: str, cache):
    """The temporal-mixing half of an "ssm" or "rglru" block. In "prefill"
    and "decode" the new recurrent state is copied into `cache` (views of
    the stacked caches in the scanned layout): the block returns it, and
    the caller keeps only the cache it passed in."""
    if kind == "ssm":
        p_k, prefill, step = (p["ssm"], ssm_mod.ssm_prefill,
                              ssm_mod.ssm_decode_step)
    else:
        p_k, prefill, step = (p["rglru"], rglru_mod.rglru_prefill,
                              rglru_mod.rglru_decode_step)
    if mode == "decode":
        y, new = step(p_k, h, cfg, cache)
    else:
        y, new = prefill(p_k, h, cfg)
    if mode != "train":
        for key, val in new.items():
            cache[key].copy_(val)
    return y, cache


# ----------------------------------------------------------------- the stacks
def _stacked(spec: ParamSpec, n: int) -> ParamSpec:
    return dataclasses.replace(spec, shape=(n,) + spec.shape,
                               axes=("layers",) + spec.axes)


def stack_specs(cfg: ModelConfig, scan: bool, dtype=torch.bfloat16,
                depth0: int = 1) -> Any:
    """Specs of the main stack, layer-provenance tagged. Scanned: one tree
    with a leading layer dim on every leaf, all at depth ``depth0`` (its
    gradient materializes whole, so there is no finer release to order).
    Unrolled: a list of per-layer trees, layer i at depth ``depth0 + i``."""
    kinds = block_kinds(cfg)
    if scan and uniform_stack(cfg):
        one = layer_specs(cfg, kinds[0], dtype)
        return tag_layer(map_specs(lambda s: _stacked(s, cfg.num_layers),
                                   one), depth0)
    return [tag_layer(layer_specs(cfg, k, dtype), depth0 + i)
            for i, k in enumerate(kinds)]


def _layer(tree, i: int):
    """Layer i of a scanned tree: views of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, ParamTree):
        return {k: _layer(v, i)
                for k, v in {**tree._parameters, **tree._modules}.items()}
    return tree[i]


def _unbind(tree) -> list:
    """The layers of a scanned tree, each leaf unbound once (one autograd
    node per stacked leaf, whose backward stacks the per-layer grads)."""
    if isinstance(tree, ParamTree):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree))


def is_unrolled(layers) -> bool:
    return isinstance(layers, (list, tuple, nn.ModuleList))


def stack_apply(params, x, cfg: ModelConfig, positions, mode: str, caches,
                pos, attn_impl: str, remat: str = "none", mesh=None,
                stream=None, enc_out=None, tp=None, a2a_chunks: int = 1):
    """Run the full stack. `params` matches :func:`stack_specs`' layout
    (stacked tree for scan, list for unrolled), `caches` that of
    :func:`stack_cache_specs` (or None in "train" mode). The caches are
    written in place through per-layer views. `remat` ("none" | "full" |
    "dots") applies in "train" mode: "full" keeps only each layer's input
    and recomputes the layer in the backward; "dots" also keeps the
    outputs of the layer's projections (:func:`_dots_policy`). `mesh` and
    `a2a_chunks` go to the MoE blocks, `enc_out` (the encoder's output,
    train and prefill) to the decoder blocks. Returns (x, caches, aux),
    aux the f32 sum of the layers' MoE aux losses (None for a stack
    without MoE blocks).

    `stream` is the per-layer gather hook ("train" mode): a callable
    ``(i, p_l) -> layer params`` that materializes layer `i`'s
    parameters from `p_l` INSIDE the layer's remat region, so the gather
    is issued just before the consuming compute, the gathered buffer dies
    after the layer's forward, and the backward's recompute regathers it
    in reverse layer order. Streaming ZeRO-3 passes its flat shard dicts
    (`params` is the list of them, unrolled); the TP step passes this
    rank's blocks, scanned (`p_l` the layer's slices) or unrolled.
    Streaming ZeRO-3 forces remat (without it every gathered buffer
    would live until its backward); the TP step's gathers follow `remat`,
    so under "none" a layer's gathered blocks live until its backward.

    `tp` is the tensor-parallel cut (:func:`layer_apply`): in "train"
    mode `x` holds this rank's rows, and under remat "full" or "dots"
    each layer's recompute re-issues its forward collectives in the
    backward, in the same order on every rank; in "prefill" and "decode"
    it is the serving cells' cut, `caches` this rank's blocks.

    In "train" mode each layer runs in the span ``layer.fwd``, or
    ``layer.recompute`` when the backward recomputes it
    (``runtime/tracing.py``)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    kinds = block_kinds(cfg)
    unrolled = is_unrolled(params)
    aux = None

    def add(total, aux_l):
        return aux_l if total is None else (
            total if aux_l is None else total + aux_l)

    if mode == "train":
        layers = params if unrolled else _unbind(params)
        for i, (p_l, kind) in enumerate(zip(layers, kinds)):
            def f(xx, p_l=p_l, kind=kind, i=i):
                with layer_span():
                    if stream is not None:
                        p_l = stream(i, p_l)
                    xx, _, aux_l = layer_apply(
                        p_l, xx, cfg, kind, positions, mode, None, None,
                        attn_impl, mesh, enc_out, tp, a2a_chunks)
                return xx, aux_l
            if remat == "dots":
                x, aux_l = checkpoint(f, x, use_reentrant=False,
                                      context_fn=_DOTS_CONTEXT)
            elif remat == "full" or (stream is not None and tp is None):
                x, aux_l = checkpoint(f, x, use_reentrant=False)
            else:
                x, aux_l = f(x)
            aux = add(aux, aux_l)
        return x, None, aux
    for i, kind in enumerate(kinds):
        p_l = params[i] if unrolled else _layer(params, i)
        cache_l = None
        if caches is not None:
            cache_l = caches[i] if is_unrolled(caches) else _layer(caches, i)
        x, _, aux_l = layer_apply(p_l, x, cfg, kind, positions, mode,
                                  cache_l, pos, attn_impl, mesh, enc_out, tp,
                                  a2a_chunks)
        aux = add(aux, aux_l)
    return x, caches, aux


# ------------------------------------------------------------- remat "dots"
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The port of ``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``, which saves the output of every
    product without batch dims and recomputes everything else. Saved:
    ``aten.mm`` and ``aten.addmm`` (a 3-D activation times a weight
    matrix: the MLP, the router, the recurrent blocks' projections) and
    the ``aten.bmm`` that einsum lowers a weight projection to (batch 1;
    ``models.layers.projecting`` marks those: the attention's q, k, v and
    output projections, the cross-attention's). Recomputed: every other
    ``bmm`` (the attention scores and their values, which carry batch and
    head dims in JAX's einsums, and the experts' products, which carry the
    expert dim), the norms, softmax, gathers and elementwise work, and the
    collectives between them (the recompute issues them again)."""
    if op in _DOTS_SAVED or (op is torch.ops.aten.bmm.default
                             and projecting()):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


# ------------------------------------------------------------- cache builders
def ring_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """The slots of an attention block's ring: `max_len`, cut to the
    window of a local-attention block or of a sliding-window model."""
    if kind == "local_attn":
        return min(max_len, cfg.hybrid.local_window)
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def stack_cache_specs(cfg: ModelConfig, batch: int, max_len: int, scan: bool,
                      dtype=torch.bfloat16):
    """ParamSpec tree for the per-layer decode caches."""
    kinds = block_kinds(cfg)

    def one(kind: str):
        if kind == "ssm":
            return ssm_mod.ssm_cache_specs(cfg, batch, dtype)
        if kind == "rglru":
            return rglru_mod.rglru_cache_specs(cfg, batch, dtype)
        if kind not in ATTN_KINDS:
            raise _not_ported(f"the decode cache of block kind {kind!r}")
        c = attn.cache_specs(cfg, batch, ring_len(cfg, kind, max_len), dtype)
        if kind != "decoder":
            return c
        cross = ParamSpec((batch, cfg.encdec.enc_seq, cfg.num_kv_heads,
                           cfg.resolved_head_dim),
                          ("batch", None, "act_kv_heads", None), dtype,
                          "zeros")
        return {"self": c, "cross_k": cross, "cross_v": cross}

    if scan and uniform_stack(cfg):
        return map_specs(lambda s: _stacked(s, cfg.num_layers),
                         one(kinds[0]))
    return [one(k) for k in kinds]
