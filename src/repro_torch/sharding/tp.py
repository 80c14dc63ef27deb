"""Tensor-parallel collectives of the training step, and the cut of a
model that uses them.

This module has no file to mirror: in the JAX package GSPMD inserts these
collectives from the placements that ``with_logical`` asks for. Here they
are written out, the Megatron cut with sequence parallelism, as
``torch.autograd.Function``s over the mesh's process groups
(``ProcessMesh.axes_group``):

  :func:`all_gather`      all-gather along a dim; backward reduce-scatter
  :func:`reduce_scatter`  reduce-scatter along a dim; backward all-gather
  :func:`grad_all_reduce` identity; backward all-reduce (a leaf replicated
                          over ranks that compute on different tokens)
  :func:`all_reduce`      sum over the ranks; backward sum (a statistic
                          every rank reads whole, e.g. a norm's square sum
                          over a split width)
  :func:`take_rows`       this rank's block of a dim; backward pads with
                          zeros (a narrow)

Every backward follows one convention: the loss autograd differentiates is
the SUM of the ranks' losses, each rank's over its own tokens. Blocks are
ordered along a dim as GSPMD orders them: the placed axes of one dim taken
row-major in the order the spec names them (:func:`block_order`).

:class:`TPCut` is the cut of a block under ``DEFAULT_RULES``: between
blocks each rank holds its (b, s/tp, d) rows; attention, the MLP and the
recurrent mixers all-gather them over the "model" axis, compute with the
rank's heads or columns (``d_ff``, Mamba-2's ``d_inner``, the RG-LRU's
width) and leave through a reduce-scatter back to the rows. A block whose
heads (or columns) the rules replicate computes every head and leaves
through :func:`take_rows`: a reduce-scatter would count it tp times.

:class:`ServeCut` is the same cut for the serving cells (prefill and
decode on each rank's blocks under ``rules_for(kind)``): prefill keeps
training's rows between blocks; decode holds the whole token on every
rank and all-reduces each block's partial sums. :class:`Ring` is where a
rank's block of an attention ring lies.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import coords_rank
from repro_torch.sharding.rules import ShardingContext, resolve_pspec


def block_order(mesh, axes: Sequence[str]) -> List[int]:
    """The block index each rank of ``mesh.axes_group(axes)`` holds, by
    group rank. The group's ranks are sorted (row-major over the axes in
    mesh order); a dim placed on `axes` numbers its blocks row-major over
    the axes in the order given (GSPMD's)."""
    ks = [mesh.axis_index(a) for a in axes]
    sizes = [mesh.sizes[k] for k in ks]
    in_mesh = sorted(range(len(ks)), key=lambda i: ks[i])
    out = []
    for sub in itertools.product(*(range(sizes[i]) for i in in_mesh)):
        coord = dict(zip(in_mesh, sub))
        out.append(coords_rank([coord[i] for i in range(len(ks))], sizes))
    return out


def _inverse(order: List[int]) -> List[int]:
    inv = [0] * len(order)
    for g, k in enumerate(order):
        inv[k] = g
    return inv


def _is_identity(order: List[int]) -> bool:
    return all(g == k for g, k in enumerate(order))


def gather_dim(x: torch.Tensor, dim: int, group, order: List[int]
               ) -> torch.Tensor:
    """All-gather of every rank's block of `x` along `dim` (blocks by
    :func:`block_order`); no autograd."""
    n = len(order)
    # flat buffers: gloo takes the gathered blocks concatenated on dim 0
    buf = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, x.detach().contiguous().reshape(-1),
                                group=group)
    buf = buf.view((n,) + tuple(x.shape))
    if not _is_identity(order):
        buf = buf[_inverse(order)]
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return buf.movedim(0, dim).reshape(shape)


def scatter_dim(y: torch.Tensor, dim: int, group, order: List[int]
                ) -> torch.Tensor:
    """Reduce-scatter of `y` along `dim`: this rank's block of the sum
    over the group's ranks; no autograd."""
    n = len(order)
    size = y.shape[dim] // n
    parts = y.reshape(y.shape[:dim] + (n, size) + y.shape[dim + 1:])
    parts = parts.movedim(dim, 0)
    if not _is_identity(order):
        parts = parts[order]
    parts = parts.contiguous()
    out = torch.empty(parts[0].numel(), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, parts.reshape(-1), group=group)
    return out.view(parts.shape[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, order):
        ctx.dim, ctx.group, ctx.order = dim, group, order
        return gather_dim(x, dim, group, order)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group, ctx.order), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group, order):
        ctx.dim, ctx.group, ctx.order = dim, group, order
        return scatter_dim(y, dim, group, order)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group, ctx.order), None, None, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of `x` summed over `group` (NCCL refuses a
    strided tensor, such as a gradient that reaches a leaf transposed)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """The blocks of `x` along `dim` over the ranks of `axes`, gathered;
    the backward reduce-scatters. `x` itself where they are one rank."""
    group = mesh.axes_group(tuple(axes))
    if group is None:
        return x
    return _AllGather.apply(x, dim, group, block_order(mesh, axes))


def reduce_scatter(y: torch.Tensor, dim: int, mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `y` over the ranks of
    `axes`; the backward all-gathers."""
    group = mesh.axes_group(tuple(axes))
    if group is None:
        return y
    return _ReduceScatter.apply(y, dim, group, block_order(mesh, axes))


def grad_all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]
                    ) -> torch.Tensor:
    """`x` unchanged; its gradient is summed over the ranks of `axes`."""
    group = mesh.axes_group(tuple(axes))
    if group is None:
        return x
    return _GradAllReduce.apply(x, group)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of `x` over the ranks of `axes`; every rank's loss reads
    the sum, so the backward sums the gradient over them too."""
    group = mesh.axes_group(tuple(axes))
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def take_rows(x: torch.Tensor, dim: int, n: int, index: int
              ) -> torch.Tensor:
    """Block `index` of `n` along `dim`; the backward pads with zeros."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


# ------------------------------------------------------------------ the cut
def _places(spec, dim: int, axis: str) -> bool:
    """Whether a resolved spec places dim `dim` over `axis` (alone or in a
    tuple of axes)."""
    e = (tuple(spec) + (None,) * (dim + 1))[dim]
    return e == axis or (isinstance(e, tuple) and axis in e)


@dataclass
class TPCut:
    """The tensor-parallel cut of a model's blocks on one mesh: its
    "model" axis (`axis`, `n` ranks, this rank at `index`), and whether the
    rules shard over it the query heads, the KV heads and the MLP columns
    (``d_ff``), Mamba-2's ``d_inner`` columns (`inner`) and SSD heads
    (`ssm_heads`), the RG-LRU's width (`lru`), the MoE experts
    (`experts`: expert parallelism) and, where they do not, the experts'
    ``d_ff_expert`` columns (`expert_cols`: expert TP); each False where
    they replicate that dim, and the block follows. Whisper's encoder layers have the
    decoder's head counts and ``d_ff``, so one cut serves both. `a2a_log`
    (None, or a list) is handed to the MoE blocks' all-to-alls
    (:func:`~repro_torch.core.a2a_scan.a2a_scan`'s `log`)."""

    mesh: object
    axis: str
    n: int
    index: int
    heads: bool
    kv_heads: bool
    mlp: bool
    inner: bool = False
    ssm_heads: bool = False
    lru: bool = False
    experts: bool = False
    expert_cols: bool = False
    a2a_log: Optional[list] = None

    @classmethod
    def for_model(cls, cfg, mesh, ctx: ShardingContext,
                  axis: str = "model") -> "TPCut":
        hd = cfg.resolved_head_dim

        def placed(shape, axes, dim):
            return _places(resolve_pspec(shape, axes, ctx), dim, axis)

        d = cfg.d_model
        extra = {}
        if cfg.ssm is not None:
            extra.update(
                inner=placed((d, cfg.ssm.d_inner(d)), ("embed", "mlp"), 1),
                ssm_heads=placed((d, cfg.ssm.num_heads(d)),
                                 ("embed", "heads"), 1))
        if cfg.hybrid is not None:
            extra["lru"] = placed((d, cfg.hybrid.lru_width or d),
                                  ("embed", "lru"), 1)
        if cfg.moe is not None:
            m = cfg.moe
            shape = (m.num_experts, d, m.d_ff_expert)
            axes = ("experts", "embed", "expert_mlp")
            extra["experts"] = placed(shape, axes, 0)
            extra["expert_cols"] = placed(shape, axes, 2)
        return cls(mesh, axis, mesh.shape[axis],
                   mesh.coords[mesh.axis_index(axis)],
                   heads=placed((d, cfg.num_heads, hd),
                                ("embed", "heads", "head_dim"), 1),
                   kv_heads=placed((d, cfg.num_kv_heads, hd),
                                   ("embed", "kv_heads", "head_dim"), 1),
                   mlp=placed((d, cfg.d_ff), ("embed", "mlp"), 1), **extra)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 1, the sequence) of a (b, s, ...) tensor
        every rank of the model line holds whole."""
        if x.shape[1] % self.n:
            raise ValueError(f"sequence {x.shape[1]} does not divide over "
                             f"the {self.n} ranks of {self.axis!r}")
        return take_rows(x, 1, self.n, self.index)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, 1, self.mesh, (self.axis,))

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of the last dim, gathered."""
        return all_gather(x, x.dim() - 1, self.mesh, (self.axis,))

    def scatter_cols(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim of the sum of `y` over the
        ranks (partial sums over the rank's rows of a weight placed on
        its input dim)."""
        return reduce_scatter(y, y.dim() - 1, self.mesh, (self.axis,))

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim of a tensor every rank holds
        whole (a replicated vector, or a complete output); the backward
        pads with zeros."""
        return take_rows(x, x.dim() - 1, self.n, self.index)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.mesh, (self.axis,))

    def leave(self, y: torch.Tensor, sharded: bool) -> torch.Tensor:
        """A block's output over the whole sequence back to this rank's
        rows: partial sums over the rank's heads or columns are
        reduce-scattered; a complete (replicated) output is cut."""
        if sharded:
            return reduce_scatter(y, 1, self.mesh, (self.axis,))
        return take_rows(y, 1, self.n, self.index)

    def kv_read(self, hq: int, hkv: int
                ) -> Tuple[int, int, Optional[List[int]]]:
        """Where the rules shard the query heads but replicate the KV heads:
        (lo, hi, idx), the KV heads [lo, hi) this rank's query heads read,
        and, when they are not whole groups, the KV head of each local
        query head (relative to lo), else None."""
        hl, g = hq // self.n, hq // hkv
        first = self.index * hl
        lo, hi = first // g, (first + hl - 1) // g + 1
        if hl % g == 0 or g % hl == 0:
            return lo, hi, None
        return lo, hi, [(first + j) // g - lo for j in range(hl)]


@dataclass(frozen=True)
class Ring:
    """This rank's block of a ``w``-slot attention ring: the mesh axes its
    slots are split over (`slots`, () where every rank holds them all),
    its slots ``[lo, lo + size)``, the axes its KV heads are split over
    (`heads`), and the process group of `slots` (None where that is one
    rank: the ring is then decoded whole)."""

    w: int
    slots: Tuple[str, ...]
    lo: int
    size: int
    heads: Tuple[str, ...]
    group: object = None


@dataclass
class ServeCut(TPCut):
    """:class:`TPCut` for the serving cells, on a mesh whose rules are the
    cell's (`ctx`): whether the rules place the vocabulary over the
    "model" axis (`vocab`: the embedding is then looked up on the rank's
    block and the head gives the rank's block of the logits), the
    cell's global `batch`, and the ring length the caches are sized for
    (`max_len`, set per call), from which :meth:`ring` places each ring
    as the rules place ``("batch", "kv_seq", "act_kv_heads", None)``."""

    ctx: object = None
    vocab: bool = False
    batch: int = 1
    kv_heads_n: int = 1
    head_dim: int = 1
    max_len: int = 0

    def __post_init__(self):
        self._rings = {}

    @classmethod
    def for_cell(cls, cfg, mesh, ctx: ShardingContext, batch: int,
                 axis: str = "model") -> "ServeCut":
        base = TPCut.for_model(cfg, mesh, ctx, axis)
        vocab = _places(resolve_pspec((cfg.vocab_size, cfg.d_model),
                                      ("vocab", "embed"), ctx), 0, axis)
        fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
        return cls(**fields, ctx=ctx, vocab=vocab, batch=batch,
                   kv_heads_n=cfg.num_kv_heads,
                   head_dim=cfg.resolved_head_dim)

    def ring(self, w: int) -> Ring:
        """The placement of a ``w``-slot ring on this rank (its process
        group created beforehand: ``launch/steps.py`` ``serve_groups``)."""
        if w not in self._rings:
            from repro_torch.checkpoint.elastic import block_index
            from repro_torch.sharding.rules import entry_axes

            shape = (self.batch, w, self.kv_heads_n, self.head_dim)
            spec = tuple(resolve_pspec(
                shape, ("batch", "kv_seq", "act_kv_heads", None),
                self.ctx)) + (None,) * 4
            idx = block_index(shape, spec, self.mesh)
            slots = entry_axes(spec[1])
            self._rings[w] = Ring(
                w, slots, idx[1].start, idx[1].stop - idx[1].start,
                entry_axes(spec[2]),
                self.mesh.axes_group(slots) if slots else None)
        return self._rings[w]

    def rows_of_sum(self, x: torch.Tensor, summed: bool) -> torch.Tensor:
        """This rank's rows of a (b, s, ...) tensor: of the sum of the
        ranks' `x` where they are partial sums (`summed`), else of `x`."""
        if summed:
            return reduce_scatter(x, 1, self.mesh, (self.axis,))
        return self.rows(x)

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's heads (dim 2) of a (b, s, h, d) tensor."""
        return all_gather(x, 2, self.mesh, (self.axis,))

    def heads_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the heads (dim 2)."""
        return take_rows(x, 2, self.n, self.index)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send[j]`` to rank j of the line; block i of the result came
        from rank i."""
        group = self.mesh.groups[self.axis]
        if group is None:
            return send
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous(), group=group)
        return out


def global_norm_by_class(grads: Sequence[torch.Tensor],
                         classes: Sequence[Tuple[str, ...]], mesh
                         ) -> torch.Tensor:
    """sqrt of the float32 sum of squares of the whole tree, over unique
    elements: each block's square sum is all-reduced over the axes that
    shard it (`classes[i]`, in mesh order), once per placement class, and
    never over the axes it is replicated on."""
    per: dict = {}
    for g, cls in zip(grads, classes):
        sq = torch.sum(torch.square(g.float()))
        per[cls] = sq if cls not in per else per[cls] + sq
    total = None
    for cls in sorted(per, key=lambda c: (len(c), c)):
        sq = per[cls]
        group = mesh.axes_group(cls) if cls else None
        if group is not None:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)
