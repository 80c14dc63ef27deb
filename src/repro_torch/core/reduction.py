"""Hierarchical task->process reductions (paper §3.3, Code 5).

Concurrent tasks reduce their subdomain partials privately (OmpSs-2's
`reduction(MAX:rlocal)`); one process-level all-reduce then combines the
ranks (the paper's `MPI_Allreduce`). Here the task level is a tree of
elementwise tensor ops inside one rank and the process level is
``dist.all_reduce`` over the mesh axes' process groups. Nothing leaves the
device: the result stays a tensor, so a solver loop never waits on the host.
"""
from __future__ import annotations

from typing import Sequence, Union

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
