"""Two-phase vs HDOT gradient synchronisation (paper §3.1-3.2), the port of
the grad-sync half of ``repro/core/overlap.py``.

Gradient synchronisation is the LM-training analogue of the paper's halo
exchange: the "two-phase" code computes the whole backward pass, then
reduces the whole gradient in one monolithic collective (a serial
communication phase). The HDOT schedule over-decomposes the gradient set
into layer-aligned buckets (subdomains of the parameter domain) whose
reductions are independent collectives, issued last-backward-first so they
overlap the rest of the backward.

In the JAX package the overlap is left to XLA's scheduler. Eager PyTorch
has none, and a reduction issued after ``backward()`` overlaps nothing, so
the port has two forms of the HDOT sync:

- :func:`grad_sync` (``mode="hdot"`` or ``"two_phase"``), functional over
  a finished gradient tree, as in the JAX package: the two-phase baseline
  of the trainer, and the tests' reference;
- :class:`GradBuckets`, the trainer's HDOT schedule at backward time: each
  bucket owns one flat gradient buffer per dtype and every parameter's
  ``.grad`` is a view into it (no staging copy: the counterpart of the JAX
  package's multi-operand psum); a post-accumulate-grad hook counts the
  leaves that are ready, and a bucket's asynchronous all-reduce is issued
  as soon as it is complete and every bucket before it in emission order
  has been issued, so every rank issues the same collectives in the same
  order while the backward goes on.

Also provides microbatch gradient accumulation (the sequence-of-subdomains
view of the global batch). The FSDP (ZeRO-3) half waits (``ROADMAP.md``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.layers import leaf_paths, rebuild, tree_leaves, tree_map

PyTree = Any


# ------------------------------------------------------------------ bucketing
def make_buckets(tree: PyTree, num_buckets: int,
                 layers: Optional[PyTree] = None,
                 order: str = "reverse_topo") -> List[List[Tuple[int, Any]]]:
    """Group tree leaves into at most `num_buckets` buckets — the HDOT
    subdomains of the gradient domain. Returns [[(leaf_idx, leaf), ...], ...]
    in collective EMISSION order (leaf indices in tree order, dict keys
    sorted, as ``jax.tree.leaves``).

    Without `layers`: greedy size-balanced grouping, leaf order preserved
    inside a bucket (the legacy schedule; emission order is tree order).

    With `layers` (a tree of int forward depths matching `tree`, e.g.
    ``LanguageModel.param_layers()``): leaves are grouped by depth, depth
    groups are merged into ~size-balanced CONTIGUOUS buckets (cuts only at
    layer boundaries), and the bucket list is ordered by `order`:

      'reverse_topo'  deepest (last-backward) first — the bucket whose grads
                      complete earliest in the backward pass is emitted first,
                      so its collective overlaps the remaining backward.
      'tree'          shallowest first (forward/tree order).
      'layer'         one bucket PER distinct depth, shallowest first
                      (`num_buckets` is ignored).
    """
    leaves = tree_leaves(tree)
    if not leaves:
        return []
    num_buckets = max(1, min(num_buckets, len(leaves)))
    if layers is None:
        sizes = [(i, _leaf_size(l)) for i, l in enumerate(leaves)]
        # greedy: biggest leaf into currently-smallest bucket
        buckets: List[List[int]] = [[] for _ in range(num_buckets)]
        load = [0] * num_buckets
        for i, sz in sorted(sizes, key=lambda t: -t[1]):
            b = load.index(min(load))
            buckets[b].append(i)
            load[b] += sz
        return [[(i, leaves[i]) for i in sorted(b)] for b in buckets if b]

    if order not in ("reverse_topo", "tree", "layer"):
        raise ValueError(f"unknown bucket order {order!r}")
    tags = tree_leaves(layers)
    if len(tags) != len(leaves):
        raise ValueError(
            f"layer-provenance tree has {len(tags)} leaves but the gradient "
            f"tree has {len(leaves)} — tag every leaf (models/*.py)")
    by_depth: Dict[int, List[int]] = {}
    for i, t in enumerate(tags):
        by_depth.setdefault(int(t), []).append(i)
    if order == "layer":
        return [[(i, leaves[i]) for i in sorted(by_depth[d])]
                for d in sorted(by_depth)]
    depths = sorted(by_depth, reverse=(order == "reverse_topo"))
    total = sum(_leaf_size(leaves[i]) for i in range(len(leaves)))
    # contiguous partition of the depth sequence: group g goes to the bucket
    # its cumulative-size midpoint falls in — cuts land only on layer
    # boundaries, loads stay within one layer's size of balanced
    buckets, cum = [[] for _ in range(num_buckets)], 0
    for d in depths:
        size_d = sum(_leaf_size(leaves[i]) for i in by_depth[d])
        b = min(num_buckets - 1, (cum + size_d // 2) * num_buckets // total)
        buckets[b].extend(sorted(by_depth[d]))
        cum += size_d
    return [[(i, leaves[i]) for i in b] for b in buckets if b]


def _leaf_size(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel()
    shape = getattr(leaf, "shape", ())
    return math.prod(shape) if shape else 1


def _dp_group(mesh, axes: Sequence[str]):
    """The group of the DP replicas over `axes`, None without a mesh or
    where they are one rank (the sync is then the identity)."""
    return None if mesh is None else mesh.axes_group(tuple(axes))


def grad_sync_two_phase(grads: PyTree, mesh, axes: Sequence[str]) -> PyTree:
    """Paper baseline: ONE monolithic reduction of the flattened gradient,
    in the dtype the leaves promote to (float32 for bf16 and float32
    leaves), cast back into each leaf. Reduces `grads` in place and returns
    it."""
    leaves = tree_leaves(grads)
    group = _dp_group(mesh, axes)
    if not leaves or group is None:
        return grads  # one rank, or nothing to reduce: send nothing
    dtype = functools.reduce(torch.promote_types, (l.dtype for l in leaves))
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    dist.all_reduce(flat, group=group)
    off = 0
    for l in leaves:
        l.copy_(flat[off:off + l.numel()].view(l.shape))
        off += l.numel()
    return grads


def grad_sync_hdot(grads: PyTree, mesh, axes: Sequence[str],
                   num_buckets: int = 8, layers: Optional[PyTree] = None,
                   order: str = "reverse_topo") -> PyTree:
    """HDOT: per-bucket reductions, independent collectives. Zero-copy:
    every leaf is reduced in place in its own dtype, never concatenated
    into a staging buffer. The buckets' all-reduces are issued
    asynchronously in emission order (:func:`make_buckets`) and waited on
    at the end. Returns `grads`."""
    group = _dp_group(mesh, axes)
    if group is None:
        return grads
    handles = []
    for bucket in make_buckets(grads, num_buckets, layers=layers, order=order):
        for _, leaf in bucket:
            handles.append(dist.all_reduce(leaf, group=group, async_op=True))
    for h in handles:
        h.wait()
    return grads


def grad_sync(grads: PyTree, mesh, axes: Sequence[str], mode: str = "hdot",
              num_buckets: int = 8, layers: Optional[PyTree] = None,
              order: str = "reverse_topo") -> PyTree:
    """Sum `grads` over the DP replicas on `axes` of `mesh`, in place."""
    if mode == "hdot":
        return grad_sync_hdot(grads, mesh, axes, num_buckets, layers=layers,
                              order=order)
    if mode in ("none", "two_phase"):
        return grad_sync_two_phase(grads, mesh, axes)
    raise ValueError(f"unknown overlap mode {mode!r}")


def pmean(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean of `x` over the DP replicas on `axes` (``lax.pmean``)."""
    group = _dp_group(mesh, axes)
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


class GradBuckets:
    """The HDOT gradient sync at backward time, for the parameters
    `params` of one trainer.

    ``make_buckets(params, num_buckets, layers, order)`` cuts the leaves
    into buckets in emission order. Each bucket owns one flat buffer per
    dtype: the parameters' dtypes, or float32 when ``accum_steps > 1``
    (accumulation is in float32, as in the JAX package). With one
    microbatch every parameter's ``.grad`` is a view of its bucket's buffer,
    so the backward accumulates straight into it; with several, each
    microbatch's ``.grad`` is added into the float32 view (``a + b.float()``)
    and released. A post-accumulate-grad hook on every parameter counts the
    bucket's ready leaves; in the last microbatch's backward a complete
    bucket issues its asynchronous all-reduces once every bucket before it
    has issued. :meth:`finish` issues what is left (buckets holding a leaf
    the loss did not reach), waits on every handle and divides by the
    replica count.

    Use per step: :meth:`start`, then ``loss.backward()`` per microbatch
    with :attr:`last` set for the final one, then :meth:`finish`. On one
    rank (no group) nothing is sent; the buffers, views and hooks are the
    same."""

    def __init__(self, params, mesh, axes: Sequence[str], num_buckets: int,
                 layers: Optional[PyTree] = None, order: str = "reverse_topo",
                 accum_steps: int = 1):
        self.leaves = tree_leaves(params)
        self.group = _dp_group(mesh, axes)
        self.n_shards = (1 if self.group is None
                         else dist.get_world_size(self.group))
        self.accum_steps = accum_steps
        self.buckets = [[i for i, _ in b] for b in make_buckets(
            params, num_buckets, layers=layers, order=order)]
        self.grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        self.flats: List[List[torch.Tensor]] = []
        self.bucket_of: Dict[int, int] = {}
        for k, bucket in enumerate(self.buckets):
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i in bucket:
                dt = torch.float32 if accum_steps > 1 else self.leaves[i].dtype
                by_dtype.setdefault(dt, []).append(i)
                self.bucket_of[i] = k
            flats = []
            for dt, idxs in by_dtype.items():
                flat = torch.zeros(sum(self.leaves[i].numel() for i in idxs),
                                   dtype=dt, device=self.leaves[idxs[0]].device)
                off = 0
                for i in idxs:
                    n = self.leaves[i].numel()
                    self.grads[i] = flat[off:off + n].view(self.leaves[i].shape)
                    off += n
                flats.append(flat)
            self.flats.append(flats)
        self.issued: List[int] = []
        self._handles: list = []
        self._pending: List[int] = []
        self.last = True
        self._hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(self._ready, i))
            for i, p in enumerate(self.leaves)]

    def start(self) -> None:
        """Zero the buffers and the counts for a new step."""
        for flats in self.flats:
            for flat in flats:
                flat.zero_()
        for p, g in zip(self.leaves, self.grads):
            p.grad = g if self.accum_steps == 1 else None
        self.issued, self._handles = [], []
        self._pending = [len(b) for b in self.buckets]
        self.last = True

    @torch.no_grad()
    def _ready(self, i: int, p: torch.Tensor) -> None:
        if self.accum_steps > 1:
            self.grads[i].add_(p.grad.float())
            p.grad = None
            if not self.last:
                return
            self.grads[i].mul_(1.0 / self.accum_steps)
        k = self.bucket_of[i]
        self._pending[k] -= 1
        if self._pending[k] == 0:
            self._issue_ready()

    def _issue_ready(self, flush: bool = False) -> None:
        while len(self.issued) < len(self.buckets) and (
                flush or self._pending[len(self.issued)] == 0):
            k = len(self.issued)
            self.issued.append(k)
            if self.group is not None:
                self._handles.extend(
                    dist.all_reduce(flat, group=self.group, async_op=True)
                    for flat in self.flats[k])

    @torch.no_grad()
    def finish(self) -> List[torch.Tensor]:
        """Issue what is left in order, wait, divide by the replica count;
        the synced gradients, in tree order (views of the buffers)."""
        self._issue_ready(flush=True)
        for h in self._handles:
            h.wait()
        self._handles = []
        if self.n_shards > 1:
            for flats in self.flats:
                for flat in flats:
                    flat.div_(self.n_shards)
        return list(self.grads)

    def remove(self) -> None:
        """Take the hooks off the parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []


# --------------------------------------------------------- microbatch accum
def microbatch_split(batch: PyTree, steps: int) -> PyTree:
    """(B, ...) -> (steps, B/steps, ...) for accumulation."""
    def split(x):
        b = x.shape[0]
        if b % steps != 0:
            raise ValueError(
                f"global batch {b} is not divisible by accum steps {steps}")
        return x.reshape(steps, b // steps, *x.shape[1:])
    return tree_map(split, batch)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: the loss (detached) and its
    gradients w.r.t. every leaf of `params` (a tree of nested dicts and
    lists, zeros where the loss does not reach a leaf), by
    ``torch.autograd.grad`` (``.grad`` is not touched)."""
    def f(params, batch):
        paths = leaf_paths(params)
        loss = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, list(paths.values()),
                                 allow_unused=True)
        grads = {p: torch.zeros_like(v) if g is None else g
                 for (p, v), g in zip(paths.items(), gs)}
        return loss.detach(), rebuild(tree_map(lambda _: None, params),
                                      grads)
    return f


def accumulate_grads(loss_and_grad: Callable[[PyTree, PyTree],
                                             Tuple[torch.Tensor, PyTree]],
                     params: PyTree, batch: PyTree,
                     steps: int) -> Tuple[torch.Tensor, PyTree]:
    """Gradient accumulation over `steps` microbatches.

    Each microbatch is a task-level subdomain of the global batch (the HDOT
    over-decomposition along the batch axis); partial gradients are the
    task-level reduction partials, accumulated in float32 from zeros and
    scaled by 1/steps at the end, as in the JAX package."""
    if steps == 1:
        return loss_and_grad(params, batch)
    micro = microbatch_split(batch, steps)
    loss_acc = 0.0
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    acc_leaves = tree_leaves(g_acc)
    for j in range(steps):
        loss, g = loss_and_grad(params, tree_map(lambda x: x[j], micro))
        with torch.no_grad():
            for a, b in zip(acc_leaves, tree_leaves(g)):
                a.add_(b.float())
        loss_acc = loss_acc + loss.float()
    inv = 1.0 / steps
    for a in acc_leaves:
        a.mul_(inv)
    return loss_acc * inv, g_acc
