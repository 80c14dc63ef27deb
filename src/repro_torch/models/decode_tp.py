"""TP-sharded continuous-batching decode step on the HDOT collective matmuls.

The port of ``repro/models/decode_tp.py``. One decode token per slot is
tiny compute over large weights, the classic latency-critical TP cell. The
step runs on every rank of a ("data", "model") :class:`~repro_torch.launch.
mesh.ProcessMesh`, and every projection and FFN matmul rides
:func:`~repro_torch.core.collective_matmul.ag_matmul` /
:func:`~repro_torch.core.collective_matmul.matmul_rs`, so each ring hop
travels while the previous chunk's matmul runs (the paper's
communication-task overlap).

Layout per TP rank (Megatron + sequence parallelism over the SLOT dim):

  x_sp (slots_loc/tp, d)  --ag-ring-->  fused QKV (slots_loc, heads_loc)
  GQA attention fully local on the rank's KV heads of its slots' caches
  out --rs-ring--> x_sp;  the same ag/rs pair for the fused gate|up / down
  MLP; one final ag ring into the replicated unembedding = full logits.

Rings per step: 4 * num_layers + 1. The "data" axis is slot parallelism:
its only message is the all-gather of the logits at the end, so every rank
returns the logits of all slots, as the JAX step's ``P(data)`` output hands
back the global array.

Weights: the JAX cell slices and concatenates the rank's weights inside
every step. Here they are cut once per parameter tree, at the step's first
call with it (the step has the server's signature and only sees the
parameters then), and kept: ``wq|wk|wv`` of the rank's heads fused into one
``wqkv``, ``gate|up`` of its ``d_ff`` columns fused (copies, ~3.5 GB a rank
for Qwen3-8B at tp 4), ``wo`` and ``down`` of its rows (views). The values
are the JAX cell's. The cut is made anew whenever a leaf of the tree it
came from is replaced or updated in place (a restore by ``copy_``, an
optimizer step): each call compares every leaf's identity and version
counter with those the cut was made from. The step holds the cut, and
the tree's leaves, until it is given another tree or dropped.

Caches keep the server's layout, all slots and all KV heads on every rank
(the JAX step's caches are global arrays too); the step reads and writes
only this rank's view, a slot block over "data" and a KV-head block over
"model", in place. The ring writes go row by row (``index_copy_`` at the
row's slot), as the JAX cell's per-row ``dynamic_update_slice``.

``build_decode_step(model, mesh)`` returns a drop-in for
``BatchServer(decode_step_fn=...)``, which makes every rank choose the same
tokens.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import collective_matmul as cm
from repro_torch.models.attention import _sdpa_dense
from repro_torch.models.layers import apply_rope, rms_norm, tree_leaves
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import _layer, is_unrolled

PyTree = Any


def expected_permute_total(cfg: ModelConfig, slots: int, dp: int, tp: int,
                           chunks: Optional[int] = None) -> int:
    """Point-to-point sends of one hdot decode step: (4L + 1) rings (QKV-ag,
    wo-rs, gate|up-ag, down-rs per layer, plus the unembed ag), each
    ``ring_permute_count`` sends, from the same ``_ring_pieces`` split the
    step runs."""
    s_sp = slots // dp // tp
    return (4 * cfg.num_layers + 1) * cm.ring_permute_count(
        s_sp, tp, chunks=chunks)


def build_decode_step(model: LanguageModel, mesh,
                      data_axis: str = "data", model_axis: str = "model",
                      mode: str = "hdot", chunks: Optional[int] = None):
    """Returns step(params, token (b,1), caches, pos (b,)) -> ((b, 1, V) f32
    logits, caches) with the BatchServer continuous-decode calling
    convention (per-slot pos, per-slot cache ``pos`` rings).
    ``mode="two_phase"`` swaps every ring for the serial all_gather /
    reduce_scatter reference. Every rank of `mesh` must call the step
    together, with the same arguments."""
    cfg = model.cfg
    if cfg.family not in ("dense",):
        raise ValueError(
            f"TP decode cell supports the dense family, got {cfg.family!r}")
    dp = mesh.shape[data_axis]
    tp = mesh.shape[model_axis]
    hd = cfg.resolved_head_dim
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"heads ({cfg.num_heads} q / {cfg.num_kv_heads} kv) must divide "
            f"over the {tp}-way {model_axis!r} axis")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} must divide over tp={tp}")
    cm._check_mode(mode)
    hq_loc = cfg.num_heads // tp
    hkv_loc = cfg.num_kv_heads // tp
    f_loc = cfg.d_ff // tp
    d = cfg.d_model
    cut: dict = {}

    def coords():
        return (mesh.coords[mesh.axis_index(data_axis)],
                mesh.coords[mesh.axis_index(model_axis)])

    def _cut(params):
        """This rank's weights of every layer, from the replicated tree."""
        idx = coords()[1]
        hq = slice(idx * hq_loc, (idx + 1) * hq_loc)
        hkv = slice(idx * hkv_loc, (idx + 1) * hkv_loc)
        ff = slice(idx * f_loc, (idx + 1) * f_loc)
        layers = []
        for l in range(cfg.num_layers):
            pl = (params["layers"][l] if is_unrolled(params["layers"])
                  else _layer(params["layers"], l))
            ap, mp = pl["attn"], pl["mlp"]
            layers.append({
                "norm1": pl["norm1"], "norm2": pl["norm2"],
                "q_norm": ap["q_norm"] if cfg.qk_norm else None,
                "k_norm": ap["k_norm"] if cfg.qk_norm else None,
                "wqkv": torch.cat([ap["wq"][:, hq].reshape(d, hq_loc * hd),
                                   ap["wk"][:, hkv].reshape(d, hkv_loc * hd),
                                   ap["wv"][:, hkv].reshape(d, hkv_loc * hd)],
                                  dim=1),
                "wo": ap["wo"][hq].reshape(hq_loc * hd, d),
                "gate_up": torch.cat([mp["gate"][:, ff], mp["up"][:, ff]],
                                     dim=1),
                "down": mp["down"][ff]})
        wout = (params["embed"].t() if cfg.tie_embeddings
                else params["lm_head"])
        # the embedding scale rounded to the activation dtype, as in the
        # JAX package, once on the host
        scale = float(torch.tensor(d ** 0.5, dtype=params["embed"].dtype))
        return {"layers": layers, "embed": params["embed"],
                "final_norm": params["final_norm"], "wout": wout,
                "scale": scale}

    def _weights(params):
        """The cut of `params`, made anew unless every leaf is the one,
        at the version, that the kept cut was made from."""
        leaves = tree_leaves(params)
        kept = cut.get("leaves", ())
        if not (len(leaves) == len(kept) and all(
                t is k and t._version == v for t, (k, v) in zip(leaves,
                                                                kept))):
            cut.clear()
            w = _cut(params)
            cut.update(leaves=[(t, t._version) for t in leaves], w=w)
        return cut["w"]

    def _attend(w, x_sp, cache_l, pos, rows, heads):
        """The attention half of one layer on this rank's slots `rows` and
        KV heads `heads` of the caches, written in place."""
        b_loc = pos.shape[0]
        ck = cache_l["k"][rows, :, heads]
        cv = cache_l["v"][rows, :, heads]
        cpos = cache_l["pos"][rows]
        h = rms_norm(x_sp, w["norm1"], cfg.norm_eps)
        qkv = cm.ag_matmul(h, w["wqkv"], mesh, model_axis, mode, chunks)
        q = qkv[:, :hq_loc * hd].reshape(b_loc, 1, hq_loc, hd)
        k = qkv[:, hq_loc * hd:(hq_loc + hkv_loc) * hd
                ].reshape(b_loc, 1, hkv_loc, hd)
        v = qkv[:, (hq_loc + hkv_loc) * hd:].reshape(b_loc, 1, hkv_loc, hd)
        if cfg.qk_norm:
            q = rms_norm(q, w["q_norm"], cfg.norm_eps)
            k = rms_norm(k, w["k_norm"], cfg.norm_eps)
        positions = pos[:, None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        slot = pos % ck.shape[1]
        for i in range(b_loc):          # per-row ring writes
            at = slot[i:i + 1]
            ck[i].index_copy_(0, at, k[i].to(ck.dtype))
            cv[i].index_copy_(0, at, v[i].to(cv.dtype))
            cpos[i].index_copy_(0, at, pos[i:i + 1].to(cpos.dtype))
        out = _sdpa_dense(q, ck, cv, positions, cpos, causal=True,
                          window=cfg.sliding_window, kv_valid=cpos >= 0)
        return x_sp + cm.matmul_rs(out.reshape(b_loc, hq_loc * hd), w["wo"],
                                   mesh, model_axis, mode, chunks)

    def _mlp(w, x_sp):
        h2 = rms_norm(x_sp, w["norm2"], cfg.norm_eps)
        gu = cm.ag_matmul(h2, w["gate_up"], mesh, model_axis, mode, chunks)
        hm = F.silu(gu[:, :f_loc]) * gu[:, f_loc:]
        return x_sp + cm.matmul_rs(hm, w["down"], mesh, model_axis, mode,
                                   chunks)

    @torch.no_grad()
    def step(params, token, caches, pos):
        b = token.shape[0]
        if b % (dp * tp):
            raise ValueError(
                f"slots ({b}) must divide over data*model = {dp * tp} for "
                f"the sequence-parallel ring schedule")
        w = _weights(params)
        di, idx = coords()
        b_loc = b // dp
        b_sp = b_loc // tp
        rows = slice(di * b_loc, (di + 1) * b_loc)
        heads = slice(idx * hkv_loc, (idx + 1) * hkv_loc)
        pos = pos.long()[rows]
        tok_sp = token[rows, 0][idx * b_sp:(idx + 1) * b_sp]
        x_sp = F.embedding(tok_sp, w["embed"]) * w["scale"]
        unrolled = is_unrolled(caches)
        for l, wl in enumerate(w["layers"]):
            cache_l = caches[l] if unrolled else _layer(caches, l)
            x_sp = _attend(wl, x_sp, cache_l, pos, rows, heads)
            x_sp = _mlp(wl, x_sp)
        xn = rms_norm(x_sp, w["final_norm"], cfg.norm_eps)
        logits = cm.ag_matmul(xn, w["wout"], mesh, model_axis, mode,
                              chunks).float()[:, None, :]
        if dp > 1:
            full = torch.empty((b,) + tuple(logits.shape[1:]),
                               dtype=logits.dtype, device=logits.device)
            dist.all_gather_into_tensor(full, logits,
                                        group=mesh.axes_group((data_axis,)))
            logits = full
        return logits, caches

    return step
