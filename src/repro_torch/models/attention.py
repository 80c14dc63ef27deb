"""Attention: GQA (+qk-norm, +sliding window), prefill and decode paths,
and cross-attention.

The port of ``repro/models/attention.py``. Implementations (``impl``):

  dense      -- full-score einsum attention (oracle; decode path)
  blockwise  -- dense attention one chunk of query rows at a time
                (:func:`_sdpa_blockwise`; ``blockwise_unrolled`` is the
                same loop: torch has no ``lax.map``)
  flash      -- the flash attention kernel (:mod:`repro_torch.kernels.
                flash_attention`): the hand-written Hopper kernel for a
                CUDA tensor, its plain version on the CPU

The implementations share the projection, rope and mask logic, so they
are interchangeable and cross-checked in tests.

Decode against a ring whose slots are split over ranks (the serving cells'
``"kv_seq"`` placement) is the sharded flash-decode
(:func:`_flash_decode_sharded`): each rank holds a block of the slots,
computes a partial softmax over it, and the partials combine with one MAX
and two SUM all-reduces, the paper's task-level reduction applied to
attention. The ``*_tp`` functions are the blocks under the
tensor-parallel cut (``sharding/tp.py``): training's, and the serving
cells' prefill and decode.

Cross-attention (the encoder-decoder family) is the reference's: plain
attention over the encoder's keys and values, which prefill computes once
(:func:`encode_cross_kv`) and decode reads from the cache.

KV caches are dicts of tensors. Unlike the JAX package (whose arrays are
immutable), prefill and decode write the cache IN PLACE and return the same
dict: a decode step then moves one token's keys and values, not the ring.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.layers import (ParamSpec, apply_rope, project,
                                      promoted_einsum, rms_norm)

Cache = Dict[str, torch.Tensor]
NEG = -1e30


# ---------------------------------------------------------------------- specs
def attention_specs(cfg: ModelConfig,
                    dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    hd = cfg.resolved_head_dim
    s: Dict[str, ParamSpec] = {
        "wq": ParamSpec((cfg.d_model, cfg.num_heads, hd),
                        ("embed", "heads", "head_dim"), dtype),
        "wk": ParamSpec((cfg.d_model, cfg.num_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), dtype),
        "wv": ParamSpec((cfg.d_model, cfg.num_kv_heads, hd),
                        ("embed", "kv_heads", "head_dim"), dtype),
        "wo": ParamSpec((cfg.num_heads, hd, cfg.d_model),
                        ("heads", "head_dim", "embed"), dtype),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), torch.float32, "ones")
        s["k_norm"] = ParamSpec((hd,), (None,), torch.float32, "ones")
    return s


# ---------------------------------------------------------------- projections
def project_q(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    q = project("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def project_kv(p, x, cfg: ModelConfig, positions
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = project("bsd,dhk->bshk", x, p["wk"])
    v = project("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta), v


# ------------------------------------------------------------------ core sdpa
def _mask(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """(..., q, k) boolean mask. window counts the current token (SWA)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def _sdpa_dense(q, k, v, q_pos, k_pos, causal, window,
                kv_valid=None) -> torch.Tensor:
    """q: (b,sq,hq,d); k,v: (b,sk,hkv,d); q_pos (b,sq), k_pos (b,sk). GQA
    by grouping query heads over their KV head (the JAX package repeats the
    KV heads instead: the same products and sums, without the copy)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    m = _mask(q_pos, k_pos, causal, window)[:, None, None]   # (b,1,1,sq,sk)
    if kv_valid is not None:
        m = m & kv_valid[:, None, None, None, :]
    scores = torch.where(m, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window,
                    chunk: int = 1024) -> torch.Tensor:
    """:func:`_sdpa_dense` over `chunk` query rows at a time against every
    key, so the scores held at once are (b, h, chunk, sk), not (b, h, sq,
    sk); the dense function itself where `chunk` does not divide sq, as
    in the reference. The reference's "blockwise" maps the chunks with
    ``lax.map`` and its "blockwise_unrolled" unrolls them; torch has no
    ``lax.map``, so both names run this one Python loop."""
    sq = q.shape[1]
    chunk = min(chunk, sq)
    if sq % chunk:
        return _sdpa_dense(q, k, v, q_pos, k_pos, causal, window)
    return torch.cat([
        _sdpa_dense(q[:, i:i + chunk], k, v, q_pos[..., i:i + chunk], k_pos,
                    causal, window)
        for i in range(0, sq, chunk)], dim=1)


def sdpa(q, k, v, q_pos, k_pos, causal=True, window=None, impl="dense",
         kv_valid=None, chunk: int = 1024) -> torch.Tensor:
    if impl == "dense":
        return _sdpa_dense(q, k, v, q_pos, k_pos, causal, window, kv_valid)
    if impl in ("blockwise", "blockwise_unrolled"):
        return _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window, chunk)
    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        # positions are arange on both sides, as in the JAX package's flash
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------- full blocks
def self_attention(p, x, cfg: ModelConfig, positions, causal=True,
                   impl="dense", window=None) -> torch.Tensor:
    """Self-attention over the full sequence, without a cache."""
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    out = sdpa(q, k, v, positions, positions, causal=causal, window=window,
               impl=impl)
    return project("bshk,hkd->bsd", out, p["wo"])


def self_attention_tp(p, x_rows, cfg: ModelConfig, tp, window=None,
                      impl: str = "dense") -> torch.Tensor:
    """Causal self-attention under the tensor-parallel cut (``tp``, a
    :class:`~repro_torch.sharding.tp.TPCut`): `x_rows` are this rank's
    (b, s/tp, d) rows. They are all-gathered over the "model" axis, the
    queries, keys and values projected with the rank's heads (`p` holds
    its blocks), attention runs locally over the whole sequence (`impl`,
    :func:`sdpa`'s "dense" or "blockwise"),
    and ``wo`` contracts the rank's heads; the partial sums are
    reduce-scattered back to the rows. Where the rules replicate the KV
    heads but shard the query heads, the rank projects only the KV heads
    its query heads read (and repeats them per query head when those are
    not whole groups); where they replicate the query heads, the rank
    computes every head for the queries of its own rows only, against the
    whole sequence's keys and values (its rows of the complete output, so
    its scores are (b, h, s/tp, s), not (b, h, s, s))."""
    x = tp.gather_seq(x_rows)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q_pos = positions if tp.heads else tp.rows(positions)
    q = project_q(p, x if tp.heads else x_rows, cfg, q_pos)
    pk, idx = _kv_block(p, cfg, tp)
    k, v = project_kv(pk, x, cfg, positions)
    if idx is not None:
        k, v = k[:, :, idx], v[:, :, idx]
    out = sdpa(q, k, v, q_pos, positions, True, window, impl)
    y = project("bshk,hkd->bsd", out, p["wo"])
    return tp.leave(y, True) if tp.heads else y


def _kv_block(p, cfg: ModelConfig, tp):
    """(the key and value weights this rank projects, the KV head of each
    local query head or None): its KV heads where the rules shard them;
    where they shard the query heads but replicate the KV heads, the KV
    heads its query heads read (:meth:`~repro_torch.sharding.tp.TPCut.
    kv_read`), with the map when those are not whole groups."""
    pk = {"wk": p["wk"], "wv": p["wv"]}
    if cfg.qk_norm:
        pk["k_norm"] = p["k_norm"]
    idx = None
    if tp.heads and not tp.kv_heads:
        lo, hi, idx = tp.kv_read(cfg.num_heads, cfg.num_kv_heads)
        pk["wk"], pk["wv"] = pk["wk"][:, lo:hi], pk["wv"][:, lo:hi]
    return pk, idx


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    """Ring-buffer KV cache. For SWA archs max_len may be min(seq, window)."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position stored in each ring slot (-1 = empty)
        "pos": torch.full((max_len,), -1, dtype=torch.int64, device=device),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """As in the JAX package, ``pos`` starts at 0, not -1: a prefill shorter
    than the ring leaves its tail claiming position 0, and the servers mark
    it empty (:func:`repro_torch.runtime.server._mark_prefill_tail`)."""
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    axes = ("batch", "kv_seq", "act_kv_heads", None)
    return {
        "k": ParamSpec(shape, axes, dtype, "zeros"),
        "v": ParamSpec(shape, axes, dtype, "zeros"),
        "pos": ParamSpec((max_len,), ("kv_seq",), torch.int64, "zeros"),
    }


def prefill_attention(p, x, cfg: ModelConfig, positions, cache: Cache,
                      impl="dense", window=None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence attention that also fills `cache` in place."""
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    out = sdpa(q, k, v, positions, positions, causal=True, window=window,
               impl=impl)
    y = project("bshk,hkd->bsd", out, p["wo"])

    w = cache["k"].shape[1]
    s = k.shape[1]
    pos1 = positions[0] if positions.dim() > 1 else positions
    if s >= w:  # keep the last w entries, placed at their ring slots
        # decode writes position p at slot p % w: prefill must agree, else
        # the next eviction removes the wrong token
        ps = pos1[-w:]
        slots = ps % w
        cache["k"].zero_()
        cache["v"].zero_()
        cache["pos"].fill_(-1)
        cache["k"][:, slots] = k[:, -w:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -w:].to(cache["v"].dtype)
        cache["pos"][slots] = ps.to(cache["pos"].dtype)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        cache["pos"][:s] = pos1.to(cache["pos"].dtype)
    return y, cache


def decode_attention(p, x, cfg: ModelConfig, cache: Cache, pos,
                     window=None, ring=None) -> Tuple[torch.Tensor, Cache]:
    """One-token step against the ring cache. `pos` is a scalar (an int or
    a 0-d tensor: the same position for every sequence in the batch, the
    wave scheduler) or a per-slot (b,) tensor (continuous batching: every
    slot decodes at its own position; the cache then carries a per-slot
    ``pos`` of shape (b, w)).

    `ring` (a :class:`~repro_torch.sharding.tp.Ring`) says that `cache`
    holds this rank's block of the ring's slots: at a scalar `pos` over a
    group of more than one rank, the step is the sharded flash-decode
    (:func:`_flash_decode_sharded`), as the reference dispatches under a
    sharding context that places ``"kv_seq"``. Otherwise, and always at a
    per-slot `pos`, it is ``_decode_dense``."""
    b = x.shape[0]
    if torch.is_tensor(pos) and pos.dim() == 1:
        pos = pos.long()
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    out, cache = _decode_any(q, k, v, cache, pos, positions, window, ring)
    y = project("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _decode_any(q, k, v, cache: Cache, pos, positions, window, ring
                ) -> Tuple[torch.Tensor, Cache]:
    if (ring is not None and ring.group is not None
            and not torch.is_tensor(pos)):
        return _flash_decode_sharded(q, k, v, cache, pos, window, ring)
    return _decode_dense(q, k, v, cache, pos, positions, window)


def _decode_dense(q, k, v, cache: Cache, pos, positions, window
                  ) -> Tuple[torch.Tensor, Cache]:
    """An int `pos` writes one shared ring slot; a per-slot (b,) `pos`
    scatters row-wise into a per-slot (b, w) ring. In place."""
    b = q.shape[0]
    w = cache["k"].shape[1]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % w
    if torch.is_tensor(pos):
        rows = torch.arange(b, device=q.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        cpos[rows, slot] = pos.to(cpos.dtype)
        k_pos = cpos                                            # (b, w)
    else:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        cpos[slot] = pos
        k_pos = cpos.expand(b, w)
    out = _sdpa_dense(q, ck, cv, positions, k_pos, causal=True,
                      window=window, kv_valid=k_pos >= 0)
    return out, cache


def _flash_decode_sharded(q, k, v, cache: Cache, pos: int, window, ring
                          ) -> Tuple[torch.Tensor, Cache]:
    """Flash-decode over a ring whose slots are split over the ranks of
    ``ring.group``: the port of the reference's ``_flash_decode_sharded``
    (its shard_map body), with the collectives written out.

    q, k, v: (b, 1, h, d) with every head (the same on every rank of the
    group); `cache` this rank's block, slots ``[ring.lo, ring.lo +
    ring.size)`` of ``ring.w``. The rank that owns slot ``pos % w``
    writes the new key and value there; the others leave their block
    alone. Each rank takes the float32 partial softmax over its slots,
    (m, sum exp, sum exp * v); one MAX all-reduce gives the global m and
    two SUM all-reduces the sums. A rank with no visible slot (empty,
    beyond the window or in the future) adds exactly 0: its scores are
    -inf, and exp(-inf - m) with the finite global m is 0. The wire
    carries O(b h d) a layer, not the cache."""
    import torch.distributed as dist

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    b, _, hq, hd = q.shape
    hkv = ck.shape[2]
    slot = pos % ring.w
    if ring.lo <= slot < ring.lo + ring.size:
        j = slot - ring.lo
        ck[:, j] = k[:, 0].to(ck.dtype)
        cv[:, j] = v[:, 0].to(cv.dtype)
        cpos[j] = pos
    qg = q.reshape(b, 1, hkv, hq // hkv, hd).float()
    s = torch.einsum("bqhgd,bthd->bhgqt", qg, ck.float()) * (1.0 / math.sqrt(hd))
    valid = (cpos >= 0) & (cpos <= pos)
    if window is not None:
        valid &= cpos > pos - window
    s = torch.where(valid, s, -math.inf)
    m = torch.amax(s, dim=-1, keepdim=True)                  # (b,h,g,1,1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ring.group)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    den = torch.sum(e, dim=-1)                                # (b,h,g,1)
    num = torch.einsum("bhgqt,bthd->bqhgd", e, cv.float())
    dist.all_reduce(den, group=ring.group)
    dist.all_reduce(num, group=ring.group)
    _flash_decode_sharded.calls += 1
    out = num / torch.clamp(den, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, 1, hq, hd).to(q.dtype), cache


_flash_decode_sharded.calls = 0     # calls (3 all-reduces each)


# ------------------------------------------------- prefill and decode, cut
def prefill_attention_tp(p, x_rows, cfg: ModelConfig, cache: Cache, tp,
                         ring, impl="dense", window=None) -> torch.Tensor:
    """:func:`prefill_attention` under the serving cut (``tp``, a
    :class:`~repro_torch.sharding.tp.ServeCut`): `x_rows` are this
    rank's (b, s/tp, d) rows. They are all-gathered; the queries take the
    rank's heads, the keys and values its KV heads (every KV head where
    the rules replicate them: the cache holds them all); attention runs
    through `impl` (the flash kernel) on the rank's heads and the KV
    heads they read; ``wo``'s partial sums are reduce-scattered back to
    the rows. The keys and values of every position are placed into
    this rank's block of `cache` (`ring`, its placement):
    :func:`_fill_ring`. Returns the (b, s/tp, d) rows."""
    x = tp.gather_seq(x_rows)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    out = sdpa(q, _kv_for_heads(k, cfg, tp), _kv_for_heads(v, cfg, tp),
               positions, positions, causal=True, window=window, impl=impl)
    y = tp.leave(project("bshk,hkd->bsd", out, p["wo"]), tp.heads)
    _fill_ring(cache, k, v, tp, ring)
    return y


def decode_attention_tp(p, x, cfg: ModelConfig, cache: Cache, pos, tp,
                        ring, window=None) -> torch.Tensor:
    """:func:`decode_attention` under the serving cut, at a scalar `pos`:
    `x` (b, 1, d) is whole on every rank of the line. The rank projects
    its heads (and KV heads), all-gathers them over the "model" axis so
    that every rank of the ring's group holds every head, and runs the
    sharded flash-decode over its block of the slots (``_decode_dense``
    where `ring` has one rank); it keeps its heads of the output, and
    ``wo``'s partial sums are all-reduced."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    if tp.heads:
        q = tp.gather_heads(q)
    if tp.kv_heads:
        k, v = tp.gather_heads(k), tp.gather_heads(v)
    out, _ = _decode_any(q, k, v, cache, pos, positions, window, ring)
    if tp.heads:
        out = tp.heads_block(out)
    y = project("bshk,hkd->bsd", out, p["wo"])
    return tp.all_reduce(y) if tp.heads else y


def _kv_for_heads(k, cfg: ModelConfig, tp, whole: bool = False):
    """The KV heads this rank's query heads read, from `k` (b, s, h, d):
    the rank's KV heads where the rules shard them (`k` holds just those
    unless `whole`), else the block :meth:`~repro_torch.sharding.tp.
    TPCut.kv_read` names (repeated per query head when those are not
    whole groups), or every head where the query heads are replicated."""
    if not tp.heads:
        return k
    if tp.kv_heads:
        return tp.heads_block(k) if whole else k
    lo, hi, idx = tp.kv_read(cfg.num_heads, cfg.num_kv_heads)
    k = k[:, :, lo:hi]
    return k if idx is None else k[:, :, idx]


def _ring_rows(k, w: int, lo: int, size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots ``[lo, lo + size)`` of a ``w``-slot ring filled from `k`
    (b, s, h, d) at positions 0..s-1 as :func:`prefill_attention` fills
    it: ((b, size, h, d) rows, (size,) positions). Past s >= w the ring
    holds the last w positions, position p at slot p % w; below, slot j
    holds position j and the tail is empty (zeros at position 0, as the
    zero-initialised cache leaves it)."""
    s = k.shape[1]
    j = torch.arange(lo, lo + size, device=k.device)
    if s >= w:
        filled = torch.ones_like(j, dtype=torch.bool)
        p = (s - w) + torch.remainder(j - (s - w), w)
    else:
        filled = j < s
        p = torch.where(filled, j, s)
    kp = torch.cat([k, k.new_zeros((k.shape[0], 1) + tuple(k.shape[2:]))],
                   dim=1)
    return kp[:, p], torch.where(filled, p, 0)


def _fill_ring(cache: Cache, k, v, tp, ring) -> None:
    """Places the prefill's keys and values (b, s, h, d), this rank's KV
    heads or every one, into this rank's block of the ring (`ring`: its
    slot block and whether the rules split its heads). Where the rules
    split the slots over "model" and the KV heads over it too, the rank
    holds its heads of every position and wants every head of its slots:
    one all-to-all per tensor over the "model" axis moves each rank's
    heads of each slot block to the block's owner. Otherwise the rank
    cuts its block from what it holds (gathering the heads first where
    it holds a block of them and the ring wants them all)."""
    kv = (k, v)
    if tp.kv_heads and ring.slots:
        out = []
        for t in kv:
            send = torch.stack([_ring_rows(t, ring.w, j * ring.size,
                                           ring.size)[0]
                                for j in range(tp.n)])
            out.append(tp.all_to_all(send).permute(1, 2, 0, 3, 4).reshape(
                send.shape[1], ring.size, -1, send.shape[-1]))
        _, pos = _ring_rows(k[:, :, :0], ring.w, ring.lo, ring.size)
    else:
        if tp.kv_heads and not ring.heads:
            kv = tuple(tp.gather_heads(t) for t in kv)
        elif ring.heads and not tp.kv_heads:
            kv = tuple(tp.heads_block(t) for t in kv)
        rows = [_ring_rows(t, ring.w, ring.lo, ring.size) for t in kv]
        out, pos = [r[0] for r in rows], rows[0][1]
    cache["k"].copy_(out[0])
    cache["v"].copy_(out[1])
    cache["pos"].copy_(pos)


# ------------------------------------------------------------ cross-attention
def cross_attention_specs(cfg: ModelConfig,
                          dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    return attention_specs(cfg, dtype)


def cross_attention(p, x, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder-to-encoder attention over keys and values computed once at
    prefill (:func:`encode_cross_kv`): no rope on the queries, no mask over
    the ``enc_seq`` keys. Plain attention (``_sdpa_dense``), as in the
    reference, whatever the model's ``attn_impl``; its output is in x's
    dtype whatever the keys' (the reference's ``q.dtype``)."""
    b, s, _ = x.shape
    q = project("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = enc_kv
    q_pos = torch.arange(s, device=x.device).expand(b, s)
    k_pos = torch.arange(k.shape[1], device=x.device).expand(b, k.shape[1])
    out = _sdpa_dense(q, k, v, q_pos, k_pos, causal=False, window=None)
    return project("bshk,hkd->bsd", out, p["wo"])


def cross_attention_tp(p, x_rows, enc_out: torch.Tensor, cfg: ModelConfig,
                       tp, cache: Optional[Cache] = None) -> torch.Tensor:
    """:func:`cross_attention` under the tensor-parallel cut (``tp``, a
    :class:`~repro_torch.sharding.tp.TPCut`): `x_rows` are this rank's
    (b, s/tp, d) decoder rows and `enc_out` the whole encoder output
    (b, enc_seq, d), every rank's the same. The rows are all-gathered;
    the queries take the rank's heads, the keys and values the rank's KV
    heads (every KV head where the rules replicate them, of which the
    rank's query heads read theirs) over the whole encoder output;
    ``wo`` contracts the rank's heads and the partial sums are
    reduce-scattered back to the rows (where the rules replicate the
    heads, every head is computed and the rank takes its rows). Plain
    attention, as in the reference. With `cache` (the serving cells'
    prefill) the keys and values are copied into its ``cross_k`` and
    ``cross_v`` blocks."""
    x = tp.gather_seq(x_rows)
    b, s, _ = x.shape
    q = project("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = encode_cross_kv(p, enc_out, cfg)
    if cache is not None:
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)
    k, v = _kv_for_heads(k, cfg, tp), _kv_for_heads(v, cfg, tp)
    t = k.shape[1]
    q_pos = torch.arange(s, device=x.device).expand(b, s)
    k_pos = torch.arange(t, device=x.device).expand(b, t)
    out = _sdpa_dense(q, k, v, q_pos, k_pos, causal=False, window=None)
    return tp.leave(project("bshk,hkd->bsd", out, p["wo"]), tp.heads)


def cross_attention_decode_tp(p, x, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                              cfg: ModelConfig, tp) -> torch.Tensor:
    """:func:`cross_attention` of one decode token under the serving cut:
    `x` (b, 1, d) whole on every rank, `enc_kv` the cached keys and
    values with every KV head (the decode placement replicates them).
    The rank's query heads attend to the KV heads they read; ``wo``'s
    partial sums are all-reduced."""
    b = x.shape[0]
    q = project("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = (_kv_for_heads(t, cfg, tp, whole=True) for t in enc_kv)
    t = k.shape[1]
    q_pos = torch.zeros((b, 1), dtype=torch.int64, device=x.device)
    k_pos = torch.arange(t, device=x.device).expand(b, t)
    out = _sdpa_dense(q, k, v, q_pos, k_pos, causal=False, window=None)
    y = project("bshk,hkd->bsd", out, p["wo"])
    return tp.all_reduce(y) if tp.heads else y


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of the encoder's output, in the
    wider of its dtype and the weights' (float32 under the trainer's f32
    stub frames, as in the reference)."""
    k = promoted_einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = promoted_einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v
