"""Mixture-of-Experts with grouped capacity dispatch: the port of
``repro/models/moe.py``.

Tokens are processed in groups (one sequence per group, GShard-style). Each
token's router picks its top-k experts; an expert takes at most C tokens of
a group (``capacity``), ranked token-major, so later tokens are the ones
dropped. The expert products run over (E, C) slots, so their FLOPs are the
routed (active) work times the capacity factor.

:func:`moe_apply_dense` is the reference semantics on one rank.
:func:`moe_apply_ep` is expert parallelism over the mesh's ``"model"``
axis: each rank routes its own block of tokens with the same dispatch
tables, sends each expert's slots to the rank that owns the expert and
back (:func:`~repro_torch.core.a2a_scan.a2a_scan`, optionally chunked along
the capacity dim), and combines. :func:`moe_apply` picks between them
where the JAX package does; the JAX package reads its sharding context,
the port takes the mesh as an argument. :func:`moe_apply_tp` (training)
and :func:`moe_apply_cut` (the serving cells) are the block under the
tensor-parallel cut, where each rank holds its token block and its
experts; where the experts do not divide the "model" axis the rules
replicate them and split their columns instead, and both run expert TP
(:func:`moe_apply_expert_tp`, the JAX package's ``moe_apply_dense`` as
GSPMD partitions it). Every EP path takes the over-decomposition degree Q
of the all-to-alls (``ModelOptions.moe_a2a_chunks``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core.a2a_scan import a2a_scan
from repro_torch.models.layers import ParamSpec


def _require_moe(cfg: ModelConfig, who: str):
    if cfg.moe is None:
        raise ValueError(
            f"{who}: config {cfg.name!r} (family={cfg.family!r}) has no "
            f"MoEConfig — only family='moe' configs carry cfg.moe")
    return cfg.moe


def moe_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    m = _require_moe(cfg, "moe_specs")
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", None), torch.float32),
        "gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"),
                          dtype),
        "up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype),
        "down": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"),
                          dtype),
    }


def capacity(tokens_per_group: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    return max(top_k, int(math.ceil(tokens_per_group * top_k / num_experts
                                    * capacity_factor)))


def _dispatch_tables(assign: torch.Tensor, E: int, C: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """assign: (G, T, K) expert ids. Returns
       gather_ids (G, E, C)  token index feeding each expert slot (T = pad),
       slot_rank  (G, T, K)  rank of each assignment within its expert,
       keep       (G, T, K)  capacity mask.
    Ranks count the flattened (T, K) assignments token-major. Kept slots
    are unique; every dropped assignment writes the discard column E*C, so
    the scatter's order among duplicates never shows."""
    G, T, K = assign.shape
    eid = assign.reshape(G, T * K)
    experts = torch.arange(E, device=assign.device)
    # the one-hot laid out (G, E, TK), so the cumsum runs along the
    # innermost dim (on CUDA a scan along an outer dim is a serial pass)
    onehot = (eid[:, None, :] == experts[None, :, None]).to(torch.int32)
    ranks = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    rank = torch.gather(ranks, 1, eid[:, None, :])[:, 0]         # (G,TK)
    keep = rank < C
    slot = torch.where(keep, eid * C + rank, E * C)
    token = torch.arange(T, device=assign.device).repeat_interleave(K)
    buf = torch.full((G, E * C + 1), T, dtype=torch.int64,
                     device=assign.device)
    buf.scatter_(1, slot, token.expand(G, T * K))
    gather_ids = buf[:, :E * C].reshape(G, E, C)
    return gather_ids, rank.reshape(G, T, K), keep.reshape(G, T, K)


def _route(x: torch.Tensor, router: torch.Tensor, K: int):
    """f32 router logits, softmax over the experts, the top-k in
    descending order (ties to the lower expert id, as ``lax.top_k``: a
    stable descending sort), the weights renormalised over k. Returns
    (probs, weights, assign)."""
    probs = torch.softmax(x.float() @ router, dim=-1)            # (B,S,E)
    weights, assign = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, assign = weights[..., :K], assign[..., :K]
    return probs, weights / torch.sum(weights, dim=-1, keepdim=True), assign


def _load(probs: torch.Tensor, assign: torch.Tensor, E: int):
    """(f_e, p_e): each expert's mean share of the routed assignments and
    of the router's probability, over the tokens here."""
    f_e = torch.mean(torch.sum(F.one_hot(assign, E).float(), dim=2),
                     dim=(0, 1))
    return f_e, torch.mean(probs, dim=(0, 1))


def _slots_gather(x: torch.Tensor, gather_ids: torch.Tensor) -> torch.Tensor:
    """(B, E, C, D): the token rows feeding each expert slot, a zero row
    where a slot is empty."""
    B, E, C = gather_ids.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, x.shape[-1])], dim=1)
    rows = torch.arange(B, device=x.device)[:, None]
    return x_pad[rows, gather_ids.reshape(B, E * C)].reshape(B, E, C, -1)


def _combine(ye: torch.Tensor, assign, rank, keep, weights, C: int,
             dtype) -> torch.Tensor:
    """y[g, t] = sum_k keep * w_k * ye[g, e_k, rank_k]; ye (B, E*C, D)."""
    B, S, K = assign.shape
    E = ye.shape[1] // C
    ye = torch.cat([ye, ye.new_zeros(B, 1, ye.shape[-1])], dim=1)
    slot = torch.where(keep, assign * C + rank, E * C)
    rows = torch.arange(B, device=ye.device)[:, None]
    picked = ye[rows, slot.reshape(B, S * K)].reshape(B, S, K, -1)
    w = (weights * keep).to(picked.dtype)[..., None]
    return torch.sum(picked * w, dim=2).to(dtype)


def moe_apply_dense(p, x: torch.Tensor, cfg: ModelConfig, load_mean=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch on one rank; groups are sequences (G=B, T=S). The
    reference semantics, and the path for expert counts the mesh cannot
    shard. Returns (y (B, S, D) in x's dtype, f32 aux load-balancing
    loss). `load_mean` (a function of a tensor) averages the expert loads
    over other ranks' rows before the aux loss is formed. With `p`'s
    expert leaves narrowed to a block of the ``d_ff_expert`` columns
    (``gate``/``up``) and rows (``down``), `y` is that block's partial
    sum: the combine is linear in the expert outputs."""
    m = _require_moe(cfg, "moe_apply_dense")
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    C = capacity(S, E, K, m.capacity_factor)

    probs, weights, assign = _route(x, p["router"], K)
    f_e, p_e = _load(probs, assign, E)      # Switch/GShard: E·Σ f_e·p_e
    if load_mean is not None:
        f_e, p_e = load_mean(f_e), load_mean(p_e)
    aux = E * torch.sum(f_e * p_e) * m.router_aux_loss_coef

    gather_ids, rank, keep = _dispatch_tables(assign, E, C)
    xe = _slots_gather(x, gather_ids)                            # (B,E,C,D)
    h = F.silu(torch.einsum("becd,edf->becf", xe, p["gate"]))
    h = h * torch.einsum("becd,edf->becf", xe, p["up"])
    ye = torch.einsum("becf,efd->becd", h, p["down"])
    y = _combine(ye.reshape(B, E * C, D), assign, rank, keep, weights, C,
                 x.dtype)
    return y, aux


def ep_route(mesh, num_experts: int, shape) -> str:
    """Which path :func:`moe_apply` takes for an input of `shape` (B, S, D)
    on `mesh`: "ep" (tokens along the sequence), "ep_batch" (decode, the
    batch in the token slot) or "dense" — the JAX package's rule, with
    ``mesh.shape["model"]`` for its context's model-axis size."""
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    if n > 1 and num_experts % n == 0:
        if shape[1] % n == 0:
            return "ep"
        if shape[1] == 1 and shape[0] % n == 0:
            return "ep_batch"
    return "dense"


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              a2a_chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Expert parallelism (:func:`moe_apply_ep`, its
    all-to-alls chunked `a2a_chunks` ways) where `mesh` has a ``"model"``
    axis of n > 1 ranks that divides the experts and the sequence (or, at
    decode, the batch); the dense capacity dispatch everywhere else, which
    reads no `a2a_chunks`. Returns (output, aux)."""
    m = _require_moe(cfg, "moe_apply")
    route = ep_route(mesh, m.num_experts, x.shape)
    if route == "ep":
        return moe_apply_ep(expert_block(p, mesh), x, cfg, mesh,
                            a2a_chunks=a2a_chunks)
    if route == "ep_batch":
        # decode: one token per sequence, so the batch is the token domain;
        # swapped into the sequence slot, the same EP dispatch applies
        y, aux = moe_apply_ep(expert_block(p, mesh), x.transpose(0, 1), cfg,
                              mesh, tokens_on_batch=True,
                              a2a_chunks=a2a_chunks)
        return y.transpose(0, 1), aux
    return moe_apply_dense(p, x, cfg)


def expert_block(p, mesh) -> Dict[str, torch.Tensor]:
    """`p` (every expert) with its expert leaves narrowed to the experts
    this rank owns on the mesh's ``"model"`` axis, ``[m·E/n, (m+1)·E/n)``
    (views: a gradient lands in the whole leaf's rows)."""
    out = dict(p)
    if "gate" in p:
        n = mesh.shape["model"]
        me = mesh.coords[mesh.axis_index("model")]
        e = p["gate"].shape[0] // n
        for k in ("gate", "up", "down"):
            out[k] = p[k][me * e:(me + 1) * e]
    return out


def moe_apply_tp(p, x: torch.Tensor, cfg: ModelConfig, tp,
                 a2a_chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block under the training cut (``tp``, a :class:`~repro_torch.
    sharding.tp.TPCut`): `x` is this rank's (b, s/tp, d) rows, which is
    the token block the reference's ``shard_map`` gives model rank m
    (``P(batch axes, "model", None)``). Where the rules place the experts
    over the "model" axis (`p` holds the rank's experts), the block is
    routed by :func:`moe_apply_ep` at the capacity of s/tp tokens, the
    all-to-alls chunked `a2a_chunks` ways along the capacity, and the
    expert loads of the aux loss are averaged over every rank of the mesh;
    elsewhere it is :func:`moe_apply_expert_tp`. Either way each rank of
    a model line returns the same aux. Returns (the rank's (b, s/tp, d)
    rows, aux). One rank: :func:`moe_apply_dense`."""
    _require_moe(cfg, "moe_apply_tp")
    if tp.n == 1:
        return moe_apply_dense(p, x, cfg)
    if not tp.experts:
        return moe_apply_expert_tp(p, x, cfg, tp)
    return moe_apply_ep(p, x, cfg, tp.mesh, a2a_chunks=a2a_chunks,
                        log=tp.a2a_log, block=True)


def moe_apply_expert_tp(p, x: torch.Tensor, cfg: ModelConfig, tp
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert TP, the JAX package's ``moe_apply_dense`` as GSPMD
    partitions it where the experts do not divide the "model" axis (its
    docstring's "mixtral's 8 experts on a 16-wide model axis"): every rank
    holds every expert, and the rules split ``d_ff_expert`` over "model"
    (``tp.expert_cols``: `p`'s ``gate``/``up`` hold the rank's columns
    ``[m·f/n, (m+1)·f/n)`` and ``down`` the same rows). `x`, this rank's
    (b, s/tp, d) rows, is all-gathered over the line to (b, s, d) and
    routed over the whole sequence at the reference's capacity
    ``capacity(s, E, K, cf)``, so the drops are the reference's. The
    rank's columns give partial sums of the expert outputs; the combine
    is linear in them, so each rank combines its partials and one
    reduce-scatter returns the rows of the sum: it moves (b, s, d), not
    the (b, E, C, d) slots. Where the rules replicate the columns too,
    each rank computes the whole block and takes its rows. The aux loss
    is formed from the gathered rows, its expert loads averaged over the
    data-parallel replicas. A list `tp.a2a_log` records ``("gather", 0)``
    and ``("scatter", 0)``, the two forward collectives."""
    if tp.a2a_log is not None:
        tp.a2a_log.append(("gather", 0))
    xg = tp.gather_seq(x)
    dp = tuple(a for a in tp.mesh.axis_names if a != tp.axis)
    y, aux = moe_apply_dense(p, xg, cfg,
                             lambda v: _mean_over(v, tp.mesh, dp))
    if tp.a2a_log is not None:
        tp.a2a_log.append(("scatter", 0))
    return tp.leave(y, tp.expert_cols), aux


def moe_apply_cut(p, x: torch.Tensor, cfg: ModelConfig, tp, mode: str,
                  a2a_chunks: int = 1) -> torch.Tensor:
    """The MoE block under the serving cut (``tp``, a :class:`~repro_torch.
    sharding.tp.ServeCut`). Where the rules place the experts over its
    "model" axis (`p` holds the rank's experts): in "prefill" `x` is the
    rank's (b, s/tp, d) rows, its token block, routed as the reference's
    expert parallelism routes it (:func:`moe_apply_ep` on the block, at
    the capacity of s/tp tokens); in "decode" `x` is (b, 1, d), whole on
    every rank, and the batch is the token domain (``ep_route``'s
    "ep_batch"); where the batch does not divide, each rank runs the dense
    capacity dispatch with its experts only and the partial outputs are
    all-reduced. Both EP branches chunk their all-to-alls `a2a_chunks`
    ways. Elsewhere expert TP (`p` holds every expert's columns of the
    rank): the prefill is :func:`moe_apply_expert_tp`, and a decode step
    runs the dense dispatch on the whole (b, 1, d) with the rank's columns
    and all-reduces the partial sums. One rank: :func:`moe_apply_dense`."""
    _require_moe(cfg, "moe_apply_cut")
    if tp.n == 1:
        return moe_apply_dense(p, x, cfg)[0]
    if not tp.experts:
        if mode == "prefill":
            return moe_apply_expert_tp(p, x, cfg, tp)[0]
        y = moe_apply_dense(p, x, cfg)[0]
        return tp.all_reduce(y) if tp.expert_cols else y
    if mode == "prefill":
        return moe_apply_ep(p, x, cfg, tp.mesh, a2a_chunks=a2a_chunks,
                            log=tp.a2a_log, block=True)[0]
    if x.shape[0] % tp.n == 0:
        y, _ = moe_apply_ep(p, x.transpose(0, 1), cfg, tp.mesh,
                            tokens_on_batch=True, a2a_chunks=a2a_chunks,
                            log=tp.a2a_log)
        return y.transpose(0, 1)
    return tp.all_reduce(_dense_partial(p, x, cfg, tp.index))


def _dense_partial(p, x: torch.Tensor, cfg: ModelConfig, me: int
                   ) -> torch.Tensor:
    """:func:`moe_apply_dense`'s output restricted to the experts `p`
    holds (block `me` of the experts): their FFN over their slots, every
    other expert's slots zero in the combine."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    e = p["gate"].shape[0]
    C = capacity(S, E, K, m.capacity_factor)
    _, weights, assign = _route(x, p["router"], K)
    gather_ids, rank, keep = _dispatch_tables(assign, E, C)
    xe = _slots_gather(x, gather_ids)[:, me * e:(me + 1) * e]
    h = F.silu(torch.einsum("becd,edf->becf", xe, p["gate"]))
    h = h * torch.einsum("becd,edf->becf", xe, p["up"])
    ye = x.new_zeros((B, E, C, D))
    ye[:, me * e:(me + 1) * e] = torch.einsum("becf,efd->becd", h, p["down"])
    return _combine(ye.reshape(B, E * C, D), assign, rank, keep, weights, C,
                    x.dtype)


# ------------------------------------------------------------ expert parallel
class _MeanAllReduce(torch.autograd.Function):
    """The mean over a group's ranks; its backward is the same mean of the
    gradients (the global loss is the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


class _GatherTokens(torch.autograd.Function):
    """All-gather of each rank's token block along dim 1 over a group; the
    backward sums every rank's gradient of this rank's block."""

    @staticmethod
    def forward(ctx, y, group, n, me):
        ctx.group, ctx.me, ctx.s = group, me, y.shape[1]
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(1, ctx.me * ctx.s, ctx.s), None, None, None


def _mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return x
    return _MeanAllReduce.apply(x, mesh.axes_group(axes),
                                math.prod(mesh.shape[a] for a in axes))


def moe_apply_ep(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                 tokens_on_batch: bool = False, a2a_chunks: int = 1,
                 log: Optional[list] = None, block: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the mesh's ``"model"`` axis of n ranks.

    x: (B, S, D), the same on every rank of this rank's ``"model"`` line
    (the batch rows of this rank's data-parallel replica). Rank m of the
    line routes its token block ``x[:, m·S/n:(m+1)·S/n]`` with the same
    dispatch tables as the dense path, at the capacity of S/n tokens, and
    owns experts ``[m·E/n, (m+1)·E/n)``: `p`'s expert leaves hold just
    those E/n (:func:`expert_block` cuts them from a whole tree). The
    (n, B, E/n, C, D) slot buffer goes to the owners and
    back through :func:`a2a_scan` (chunked `a2a_chunks` ways along C), the
    owners' FFN runs over every rank's slots, and each rank combines its
    block; the blocks are all-gathered, so every rank of the line returns
    the whole (B, S, D). With `block`, `x` is already this rank's token
    block (B, S/n, D) and so is the result: nothing is gathered. The aux
    loss's expert loads are averaged over the ``"model"`` ranks and,
    unless ``tokens_on_batch`` (decode, `x` arrived
    swapped to (1, B, D)), over the mesh's other axes too, as the JAX
    package's ``pmean``s do. With ample capacity (no drops) this is the
    dense function; the per-rank capacity comes from the local token
    count, so otherwise it is not.

    Gradients: the collectives are differentiable under the convention
    that the global loss is the sum of the ranks' losses."""
    m = _require_moe(cfg, "moe_apply_ep")
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    n = mesh.shape["model"]
    if E % n != 0:
        raise ValueError(
            f"moe_apply_ep: num_experts={E} is not divisible by the model "
            f"axis size {n} ({cfg.name!r}); EP shards experts over 'model' — "
            f"use the dense/expert-TP path for this mesh")
    E_loc = E // n
    if block:
        S = S * n
    if S % n != 0:
        token_dim = "batch" if tokens_on_batch else "seq"
        raise ValueError(
            f"moe_apply_ep: token dim ({token_dim}={S}) is not divisible by "
            f"the model axis size {n} ({cfg.name!r}); the EP dispatch "
            f"shards tokens over 'model'")
    S_loc = S // n
    C = capacity(S_loc, E, K, m.capacity_factor)
    if a2a_chunks < 1 or C % a2a_chunks != 0:
        raise ValueError(
            f"moe_apply_ep: a2a_chunks={a2a_chunks} must be >=1 and divide "
            f"the expert capacity C={C} (tokens/shard={S_loc}, "
            f"num_experts={E}, top_k={K}, "
            f"capacity_factor={m.capacity_factor}, {cfg.name!r})")
    if p["gate"].shape[0] != E_loc:
        raise ValueError(
            f"moe_apply_ep: the expert leaves hold {p['gate'].shape[0]} "
            f"experts, not this rank's {E_loc} of {E} (expert_block cuts "
            f"them from a whole tree)")
    me = mesh.coords[mesh.axis_index("model")]
    xl = x if block else x[:, me * S_loc:(me + 1) * S_loc]  # (B, S_loc, D)

    probs, weights, assign = _route(xl, p["router"], K)
    f_e, p_e = _load(probs, assign, E)
    avg = ("model",) if tokens_on_batch else mesh.axis_names
    f_e, p_e = _mean_over(f_e, mesh, avg), _mean_over(p_e, mesh, avg)
    aux = E * torch.sum(f_e * p_e) * m.router_aux_loss_coef

    gather_ids, rank, keep = _dispatch_tables(assign, E, C)
    xe = _slots_gather(xl, gather_ids)                       # (B,E,C,D)
    xs = xe.reshape(B, n, E_loc, C, D).movedim(1, 0)         # (n,B,E_loc,C,D)
    gate, up, down = p["gate"], p["up"], p["down"]

    def ffn(xr, _k):
        # the owner's FFN over one received capacity slice: (source rank,
        # B, E_loc, Cq, D) -> the same layout for the return trip
        Cq = xr.shape[3]
        xf = xr.movedim(2, 0).reshape(E_loc, n * B * Cq, D)
        h = F.silu(torch.bmm(xf, gate)) * torch.bmm(xf, up)
        yf = torch.bmm(h, down)
        return yf.reshape(E_loc, n, B, Cq, D).movedim(0, 2)

    ys = a2a_scan(xs, ffn, mesh, "model", chunks=a2a_chunks, dim=3, log=log)
    ye = ys.movedim(0, 1).reshape(B, E * C, D)
    y = _combine(ye, assign, rank, keep, weights, C, x.dtype)
    if block:
        return y, aux
    return _GatherTokens.apply(y, mesh.groups["model"], n, me), aux
