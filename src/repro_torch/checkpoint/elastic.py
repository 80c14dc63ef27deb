"""Elastic re-meshing: restore a checkpoint onto a different mesh. The port
of ``repro/checkpoint/elastic.py``.

Checkpoints store logically-global arrays and placements are derived from
logical axes (``sharding.rules``), so changing the mesh (say (2, 2) to
(2, 1) after losing half the ranks) changes only where ``resolve_pspec``
places each dim: the restore re-cuts every leaf under the new mesh.

With no partitioner, a "sharding" here is the resolved spec plus this
rank's block: the index range along each dim, from the rank's coordinates
on the dim's placed axes (placed axes in a tuple taken row-major, as GSPMD
numbers its blocks). :func:`reshard` cuts a full tree to this rank's
blocks, as copies; :func:`unshard`, its inverse, all-gathers blocks back
into the full tree (a collective: every rank of the mesh calls it).
Checkpoints, ``Trainer.full_params()`` and the tests use it, never the
train step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import ParamTree
from repro_torch.sharding.rules import (PartitionSpec, ShardingContext,
                                        entry_axes, resolve_pspec)
from repro_torch.sharding.tp import block_order, gather_dim

PyTree = Any


@dataclass(frozen=True)
class Sharding:
    """One leaf's placement on one rank: the full `shape`, the resolved
    `spec`, and `index`, this rank's block as one slice per dim."""

    shape: Tuple[int, ...]
    spec: PartitionSpec
    index: Tuple[slice, ...]


def block_index(shape, spec, mesh) -> Tuple[slice, ...]:
    """This rank's block of a leaf of `shape` placed by `spec` on `mesh`
    (a ProcessMesh: its ``coords``)."""
    sizes, coords = mesh.shape, mesh.coords
    out = []
    for d, dim in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        n, k = 1, 0
        for a in axes:
            n *= sizes[a]
            k = k * sizes[a] + coords[mesh.axis_index(a)]
        size = dim // n
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def _map2(fn: Callable, tree: PyTree, other: PyTree) -> PyTree:
    """`tree`'s structure (dicts and lists; a ParamTree reads as a dict)
    with ``fn(leaf, o)`` at each leaf, `o` the entry of `other` at the same
    path (a logical-axes tuple or a Sharding is one entry)."""
    if isinstance(tree, ParamTree):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [_map2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def shardings_for(tree_specs: PyTree, axes: PyTree, mesh,
                  ctx: Optional[ShardingContext] = None) -> PyTree:
    """Sharding tree from (ParamSpec | tensor tree, logical-axes tree)."""
    ctx = ctx or ShardingContext(mesh)

    def one(leaf, ax):
        shape = tuple(leaf.shape)
        spec = resolve_pspec(shape, ax, ctx)
        return Sharding(shape, spec, block_index(shape, spec, mesh))

    return _map2(one, tree_specs, axes)


def cut(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of a full leaf, as a copy."""
    return x.detach()[sharding.index].clone()


def reshard(tree: PyTree, axes: PyTree, mesh,
            ctx: Optional[ShardingContext] = None) -> PyTree:
    """Cut a full in-memory tree to this rank's blocks under a (new) mesh,
    as copies on each leaf's device."""
    sh = shardings_for(tree, axes, mesh, ctx)
    return _map2(cut, tree, sh)


def unshard_leaf(block: torch.Tensor, sharding: Sharding, mesh
                 ) -> torch.Tensor:
    """The full leaf from every rank's block, as a new tensor: one
    all-gather per placed dim, over the ranks of that dim's axes (a
    collective: every rank of the mesh calls it, for every leaf in the same
    order)."""
    x = block.detach()
    for d, entry in enumerate(sharding.spec):
        axes = entry_axes(entry)
        group = mesh.axes_group(axes) if axes else None
        if group is not None:
            x = gather_dim(x, d, group, block_order(mesh, axes))
    if x.data_ptr() == block.data_ptr():     # nothing gathered
        x = x.clone()
    if tuple(x.shape) != sharding.shape:
        raise ValueError(f"unshard: gathered {tuple(x.shape)}, expected "
                         f"{sharding.shape}")
    return x


def unshard(tree: PyTree, shardings: PyTree, mesh) -> PyTree:
    """The full tree from this rank's blocks (`shardings` from
    :func:`shardings_for` on the same mesh), leaf by leaf in tree order."""
    return _map2(lambda b, s: unshard_leaf(b, s, mesh), tree, shardings)
