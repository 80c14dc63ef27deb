"""Hierarchical task->process reductions (paper §3.3, Code 5).

Concurrent tasks reduce their subdomain partials privately (OmpSs-2's
`reduction(MAX:rlocal)`); one process-level all-reduce then combines the
ranks (the paper's `MPI_Allreduce`). Here the task level is a tree of
elementwise tensor ops inside one rank and the process level is
``dist.all_reduce`` over the mesh axes' process groups. Nothing leaves the
device: the result stays a tensor, so a solver loop never waits on the host.

:func:`hierarchical_allreduce` stages the process level for multi-pod
meshes: reduce-scatter in-pod, all-reduce across pods (optionally through a
wire codec of :mod:`repro_torch.optim.compression`), all-gather in-pod.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

AxisNames = Union[str, Sequence[str]]

_OPS = {
    "sum": (torch.add, dist.ReduceOp.SUM),
    "max": (torch.maximum, dist.ReduceOp.MAX),
    "min": (torch.minimum, dist.ReduceOp.MIN),
}


def _op(op: str):
    if op not in _OPS:
        raise ValueError(f"unknown reduction op {op!r}; one of {sorted(_OPS)}")
    return _OPS[op]


def task_reduce(partials: Sequence[torch.Tensor], op: str = "sum"
                ) -> torch.Tensor:
    """Tree-reduce task-level (subdomain) partials inside one rank, in the
    same pairing order as the JAX package (O(log n) depth)."""
    combine, _ = _op(op)
    items = list(partials)
    if not items:
        raise ValueError("task_reduce needs at least one partial")
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(combine(items[i], items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def process_allreduce(x: torch.Tensor, mesh, axes: AxisNames,
                      op: str = "sum") -> torch.Tensor:
    """Process-level collective over the named mesh axes (the paper's
    MPI_Allreduce): one all-reduce over each named axis's line group, which
    together reduce over the sub-grid those axes span. Axes of size 1 cost
    nothing. Returns a new tensor; `x` is left as it was."""
    _, red = _op(op)
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    out = x
    for a in names:
        if mesh.shape[a] > 1:
            if out is x:
                out = x.clone()
            dist.all_reduce(out, op=red, group=mesh.groups[a])
    return out


def hdot_reduce(partials: Sequence[torch.Tensor], mesh, axes: AxisNames,
                op: str = "sum") -> torch.Tensor:
    """Full paper pattern: task-level tree reduce -> process-level
    all-reduce."""
    return process_allreduce(task_reduce(partials, op), mesh, axes, op)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """Sum over `axis`'s line group; this rank keeps its coordinate's
    slice of `dim` (``psum_scatter(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    chunks = [c.contiguous() for c in torch.chunk(x, n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=mesh.groups[axis])
    return out


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` in coordinate order over
    `axis`'s line group (``all_gather(..., tiled=True)``)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def _sum_payload(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum one codec payload leaf over `axis`, exactly as the reference's
    integer psum does. Neither gloo nor NCCL reduces int16, so an int16
    leaf is all-gathered as its raw bytes (2 bytes an element from each
    rank) and summed here in int32, in coordinate order; any other leaf is
    all-reduced."""
    n = mesh.shape[axis]
    if n == 1 or t.dtype != torch.int16:
        return process_allreduce(t, mesh, axis)
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=mesh.groups[axis])
    acc = parts[0].view(torch.int16).to(torch.int32)
    for q in parts[1:]:
        acc = acc + q.view(torch.int16).to(torch.int32)
    return acc.to(torch.int16).reshape(t.shape)


def hierarchical_allreduce(x: torch.Tensor, mesh, inner_axis: str,
                           outer_axis: Optional[str] = None,
                           scatter_dim: int = 0,
                           compress: Optional[Callable] = None,
                           decompress: Optional[Callable] = None
                           ) -> torch.Tensor:
    """Bandwidth-staged all-reduce for multi-pod meshes: reduce-scatter over
    `inner_axis` (the fast in-pod link), all-reduce over `outer_axis` (the
    slow cross-pod hop), all-gather over `inner_axis`. Equals the sum over
    both axes; the cross-pod hop carries 1/inner_size of the elements.

    `compress`/`decompress` wrap ONLY the cross-pod hop (e.g.
    :func:`repro_torch.optim.compression.make_crosspod_codec`): each leaf
    of the payload dict is summed over `outer_axis`, then decoded. The int8
    codec's ``q`` leaf is int16, which neither backend reduces; it is
    all-gathered as bytes and summed locally in int32 (:func:`_sum_payload`),
    so the sum stays exact, equal to the reference's integer psum. Per
    element of the cross-pod part each rank then sends 2·(P - 1) bytes over
    P pods, against 8·(P - 1)/P for int16 widened to int32 in a ring
    all-reduce (the bytes of plain f32): half at P = 2 (the 2 bytes of the
    reference's int16 psum), equal at P = 4, more beyond. Multi-pod meshes
    here have 2 pods, so the gather is the narrower wire.

    A shape whose `scatter_dim` does not tile over `inner_axis` takes the
    plain sum over both axes, as the reference does."""
    if x.shape[scatter_dim] % mesh.shape[inner_axis]:
        names = (inner_axis,) if outer_axis is None else (inner_axis,
                                                          outer_axis)
        return process_allreduce(x, mesh, names)
    part = _reduce_scatter(x, mesh, inner_axis, scatter_dim)
    if outer_axis is not None:
        if compress is not None:
            payload = {k: _sum_payload(t, mesh, outer_axis)
                       for k, t in compress(part).items()}
            part = decompress(payload)
        else:
            part = process_allreduce(part, mesh, outer_axis)
    return _all_gather(part, mesh, inner_axis, scatter_dim)
