"""Double-buffered all-to-all: the port of ``repro/core/a2a_scan.py``.

An expert-parallel MoE layer moves every routed token twice through an
all-to-all (dispatch to the experts' owners, combine back). `a2a_scan`
over-decomposes that transfer along one dim into ``chunks`` slices and
issues

    dispatch(k+1)  ||  compute(k)  ||  combine(k-1)

so each slice's wire time can sit under a neighbouring slice's compute: the
prologue ``dispatch(0)`` and the drain (the last combine) are peeled, as in
the reference. The JAX package leaves the overlap to XLA's scheduler; here
it is structural: every collective but the prologue is issued with
``async_op=True`` before the compute it should hide behind, and each handle
is waited only where its buffer is read. On NCCL the all-to-alls run on
NCCL's stream while the expert FFN runs on the compute stream.

The all-to-alls are ``dist.all_to_all_single`` over the line group of one
mesh axis: dim 0 of each slice (of size = the axis's rank count) is split,
block j goes to the axis's rank j, and block i of the result came from
rank i (``lax.all_to_all`` with split and concat axis 0). ``chunks=1``
sends exactly the reference's two all-to-alls, with no slicing. Chunking
preserves values whenever ``compute_fn`` treats the sliced dim
elementwise, as the expert FFN does (its products contract only the
feature dims).

Both all-to-alls are differentiable: the backward of an all-to-all with
equal splits is the same all-to-all of the gradient, issued synchronously
where autograd reaches it. Every rank builds the same graph, and the
engine runs the ready node created last first, so every rank reaches the
backward all-to-alls in one order: under ``chunks=Q`` the combines'
gradients from slice Q-1 down, then the dispatches' from slice Q-1 down.
Under remat ("full" or "dots") the recompute issues the forward's
all-to-alls again before them. A double-buffered backward (slice k+1's
gradient all-to-all in flight under slice k's FFN backward) is not
written yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` over `group`; with a `pending` list the
    call is asynchronous and its work handle is appended there (the caller
    waits it before reading the result). The backward's all-to-all of the
    gradient appends ``(tag + "_bwd", k)`` to `log` (a list, or None) as
    it is issued."""

    @staticmethod
    def forward(ctx, x, group, pending, log, tag):
        ctx.group, ctx.log, ctx.tag = group, log, tag
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        if ctx.log is not None:
            ctx.log.append((ctx.tag[0] + "_bwd", ctx.tag[1]))
        return out, None, None, None, None


def _a2a(x: torch.Tensor, group, pending: Optional[list],
         log: Optional[List], tag) -> torch.Tensor:
    if group is None:       # an axis of one rank: the all-to-all is a no-op
        return x
    return _AllToAll.apply(x.contiguous(), group, pending, log, tag)


def a2a_scan(x: torch.Tensor,
             compute_fn: Callable[[torch.Tensor, int], torch.Tensor],
             mesh, axis_name: str, *, chunks: int = 1, dim: int,
             log: Optional[List] = None) -> torch.Tensor:
    """dispatch all-to-all -> compute -> combine all-to-all, double-buffered
    over ``dim``.

    x          : this rank's tensor; dim 0 has one block per rank of
                 `axis_name` (the destination of each block).
    compute_fn : (received slice, k) -> result slice of the same shape
                 along dim 0 and ``dim``. Must be elementwise along ``dim``
                 for chunking to preserve values.
    mesh       : a :class:`~repro_torch.launch.mesh.ProcessMesh`; both
                 all-to-alls run over its `axis_name` group.
    chunks     : the number of slices Q; 1 = the monolithic pair. Must
                 divide ``x.shape[dim]``.
    dim        : the dim to over-decompose (not dim 0).
    log        : if a list, ``("dispatch" | "compute" | "combine", k)`` is
                 appended as each is issued, and ``("dispatch_bwd" |
                 "combine_bwd", k)`` as the backward issues the all-to-all
                 of that one's gradient (nothing on an axis of one rank).
    """
    group = mesh.groups[axis_name]

    def note(what: str, k: int) -> None:
        if log is not None:
            log.append((what, k))

    if chunks == 1:
        recv = _a2a(x, group, None, log, ("dispatch", 0))
        note("dispatch", 0)
        y = compute_fn(recv, 0)
        note("compute", 0)
        out = _a2a(y, group, None, log, ("combine", 0))
        note("combine", 0)
        return out
    n = x.shape[dim]
    if chunks < 1 or n % chunks != 0:
        raise ValueError(
            f"a2a_scan: chunks={chunks} must be >=1 and divide "
            f"x.shape[{dim}]={n} (x.shape={tuple(x.shape)})")
    q = n // chunks

    def dispatch(k: int):
        pending: list = []
        recv = _a2a(x.narrow(dim, k * q, q), group, pending, log,
                    ("dispatch", k))
        note("dispatch", k)
        return recv, pending

    recv, pending = dispatch(0)              # prologue: slice 0 on the wire
    outs, combines = [], []
    for k in range(chunks):
        # slice k+1 leaves before slice k's tokens are touched
        nxt = dispatch(k + 1) if k + 1 < chunks else None
        for work in pending:
            work.wait()
        y = compute_fn(recv, k)
        note("compute", k)
        # slice k streams back while slice k+1 computes; the last combine
        # is the drain
        outs.append(_a2a(y, group, combines, log, ("combine", k)))
        note("combine", k)
        if nxt is not None:
            recv, pending = nxt
    for work in combines:
        work.wait()
    return torch.cat(outs, dim)
