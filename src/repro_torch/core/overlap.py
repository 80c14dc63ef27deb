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

The FSDP (ZeRO-3) composition applies the same bucket decomposition to the
PARAMETER domain: each bucket lives as a flat buffer sharded over the DP
ranks (1/n per rank). The gather-all step all-gathers every bucket at the
top of the step (:func:`fsdp_all_gather`, forward order) and
reduce-scatters the finished gradients bucket-wise, last-backward-first
(:func:`grad_sync_fsdp`); the streaming step (:class:`FsdpStream`) gathers
each layer's bucket inside the layer's remat region, regathers it in the
backward's recompute, and reduce-scatters its gradient there, while the
earlier layers still compute.

Also provides microbatch gradient accumulation (the sequence-of-subdomains
view of the global batch).
"""
from __future__ import annotations

import functools
import math
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.layers import leaf_paths, rebuild, tree_leaves, tree_map
from repro_torch.runtime.tracing import span, step_bwd

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


def _call_weak(ref, *args) -> None:
    """Call the method `ref` (a ``weakref.WeakMethod``) if its object is
    alive."""
    method = ref()
    if method is not None:
        method(*args)


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
        # the hooks reach the buckets through a weak reference: a strong one
        # (parameter -> hook -> buckets -> parameter) is a cycle through
        # autograd's C++ state, which the cyclic GC cannot collect
        ref = weakref.WeakMethod(self._ready)
        self._hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(_call_weak, ref, i))
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
    ``torch.autograd.grad`` (``.grad`` is not touched). The loss runs in
    the span ``step.fwd``, its backward in ``step.bwd``
    (``runtime/tracing.py``)."""
    def f(params, batch):
        paths = leaf_paths(params)
        with span("step.fwd"):
            loss = loss_fn(params, batch)
        gs = torch.autograd.grad(step_bwd(loss), list(paths.values()),
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


# ----------------------------------------------------- FSDP (ZeRO-3) buckets
@dataclass(frozen=True)
class FsdpGroup:
    """One flat parameter buffer: a grad-sync bucket restricted to one dtype
    (buffers are concatenations, so leaves of different dtypes in the same
    bucket get sibling buffers sharing the bucket's schedule slot). `dtype`
    is the numpy name ("bfloat16", "float32"), as in the JAX package, so
    layouts and checkpoint keys are the same in both."""

    key: str                          # buffer name in the flat state dict
    bucket: int                       # forward-order bucket index
    dtype: str
    leaf_idx: Tuple[int, ...]         # leaves packed into this buffer
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]          # leaf start offsets in the buffer
    size: int                         # unpadded element count
    padded: int                       # size rounded up to n_shards


@dataclass(frozen=True)
class FsdpLayout:
    """Bucket-wise flat-buffer layout of a parameter tree for ZeRO-3 sharding
    over the DP ranks. ``groups`` is stored in FORWARD order (bucket 0 =
    shallowest = embedding end); the backward reduce-scatter iterates it in
    reverse — last-backward bucket first. ``treedef`` is the tree's
    structure (nested dicts and lists with None leaves)."""

    groups: Tuple[FsdpGroup, ...]
    treedef: Any
    n_shards: int
    num_leaves: int

    @property
    def keys(self) -> Tuple[str, ...]:
        return tuple(g.key for g in self.groups)

    def shard_bytes(self) -> int:
        """Per-rank bytes of one parameter copy under this layout."""
        return sum(g.padded // self.n_shards * torch_dtype(g.dtype).itemsize
                   for g in self.groups)


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def fsdp_layout(tree: PyTree, n_shards: int, num_buckets: int = 8,
                layers: Optional[PyTree] = None,
                order: str = "reverse_topo") -> FsdpLayout:
    """Cut `tree` (params, or their ParamSpecs) into the per-bucket flat
    buffers of the ZeRO-3 schedule. Buckets follow :func:`make_buckets`
    (layer-boundary cuts when `layers` is given); each is split by dtype
    into concatenable buffers padded up to a multiple of `n_shards`."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("fsdp_layout needs a non-empty parameter tree")
    buckets = make_buckets(tree, num_buckets, layers=layers, order=order)
    if layers is not None and order == "reverse_topo":
        buckets = buckets[::-1]  # store forward order; RS iterates reversed
    groups: List[FsdpGroup] = []
    for b, bucket in enumerate(buckets):
        by_dtype: Dict[str, List[int]] = {}
        for i, leaf in bucket:
            by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
        for name, idxs in sorted(by_dtype.items()):
            sizes = [_leaf_size(leaves[i]) for i in idxs]
            offsets = [sum(sizes[:j]) for j in range(len(sizes))]
            size = sum(sizes)
            groups.append(FsdpGroup(
                key=f"b{b:02d}_{name}", bucket=b, dtype=name,
                leaf_idx=tuple(idxs),
                shapes=tuple(tuple(leaves[i].shape) for i in idxs),
                offsets=tuple(offsets), size=size,
                padded=-(-size // n_shards) * n_shards))
    return FsdpLayout(groups=tuple(groups),
                      treedef=tree_map(lambda _: None, tree),
                      n_shards=n_shards, num_leaves=len(leaves))


def _pack_group(leaves: List[Any], g: FsdpGroup) -> torch.Tensor:
    """Concatenate a group's leaves into its flat (padded) buffer, in the
    leaves' dtype, zeros in the padding."""
    first = leaves[g.leaf_idx[0]]
    buf = torch.zeros(g.padded, dtype=first.dtype, device=first.device)
    for i, off in zip(g.leaf_idx, g.offsets):
        buf[off:off + leaves[i].numel()].copy_(leaves[i].reshape(-1))
    return buf


def _unpack_group(buf: torch.Tensor, g: FsdpGroup, out: List[Any]) -> None:
    """Views of a group's full flat buffer, one per leaf (into `out`)."""
    for i, off, shape in zip(g.leaf_idx, g.offsets, g.shapes):
        out[i] = buf[off:off + math.prod(shape)].view(shape)


def _rebuild(layout: FsdpLayout, leaves: List[Any]) -> PyTree:
    return rebuild(layout.treedef,
                   dict(zip(leaf_paths(layout.treedef), leaves)))


def fsdp_shard_full(tree: PyTree, layout: FsdpLayout
                    ) -> Dict[str, torch.Tensor]:
    """GLOBAL view: params tree -> {key: flat (padded,) buffer}."""
    leaves = tree_leaves(tree)
    if len(leaves) != layout.num_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, layout expects "
                         f"{layout.num_leaves}")
    return {g.key: _pack_group(leaves, g) for g in layout.groups}


def fsdp_unshard_full(flat: Dict[str, torch.Tensor],
                      layout: FsdpLayout) -> PyTree:
    """GLOBAL view: {key: flat buffer} -> params tree of views (inverse of
    :func:`fsdp_shard_full`; also reshapes optimizer-moment buffers, whose
    dtype may differ from the params')."""
    out: List[Any] = [None] * layout.num_leaves
    for g in layout.groups:
        _unpack_group(flat[g.key], g, out)
    return _rebuild(layout, out)


def fsdp_relayout(flat: Dict[str, torch.Tensor], old: FsdpLayout,
                  new: FsdpLayout) -> Dict[str, torch.Tensor]:
    """Re-cut flat FSDP buffers from one layout to another — the checkpoint
    portability path: unshard with the OLD layout, reshard with the NEW.
    Works for optimizer-moment buffers too (dtypes follow the buffers).
    Bit-exact: unpacking drops only pad elements and repacking re-pads
    with zeros."""
    if old.num_leaves != new.num_leaves:
        raise ValueError(
            f"cannot re-layout: old layout has {old.num_leaves} leaves, new "
            f"has {new.num_leaves} — the parameter tree itself changed")
    leaves = tree_leaves(fsdp_unshard_full(flat, old))
    return {g.key: _pack_group(leaves, g) for g in new.groups}


def shard_slice(full: torch.Tensor, n_shards: int, index: int
                ) -> torch.Tensor:
    """Shard `index` of `n_shards` of a flat padded buffer (a view)."""
    s = full.numel() // n_shards
    return full[index * s:(index + 1) * s]


def fsdp_group(mesh, axes: Sequence[str], layout: FsdpLayout):
    """(process group, this rank's shard index) of the DP ranks over
    `axes`: (None, 0) on one rank. Shard r is held by group rank r (the
    group's ranks sorted, so pod-major over ("pod", "data"), as
    ``P(("pod", "data"))`` shards in the JAX package)."""
    group = _dp_group(mesh, axes)
    n = 1 if group is None else dist.get_world_size(group)
    if n != layout.n_shards:
        raise ValueError(f"the layout is cut for {layout.n_shards} shards, "
                         f"the DP ranks over {tuple(axes)} are {n}")
    return group, (0 if group is None else dist.get_rank(group))


def _gather(local: torch.Tensor, group, n: int, async_op: bool = False):
    """(full buffer, work): the all-gather of every rank's shard, shard r
    at offset r·len (on one rank a copy, as a gather writes a new
    buffer)."""
    if group is None:
        return local.detach().clone(), None
    full = torch.empty(local.numel() * n, dtype=local.dtype,
                       device=local.device)
    work = dist.all_gather_into_tensor(full, local.detach().contiguous(),
                                       group=group, async_op=async_op)
    return full, work


def _scatter(full: torch.Tensor, group, n: int):
    """(this rank's shard of the sum over the ranks, work) of an
    asynchronous reduce-scatter; on one rank the buffer itself."""
    if group is None:
        return full, None
    out = torch.empty(full.numel() // n, dtype=full.dtype, device=full.device)
    return out, dist.reduce_scatter_tensor(out, full, group=group,
                                           async_op=True)


def _logged_free(log: Optional[list], key: str, views: List[Any]) -> None:
    """Log ``("free", key)`` once every leaf view of a gathered buffer has
    died: the model's last hold on it, autograd's saved copies included.
    (The buffer itself may outlive its views for a moment in a
    communication backend's thread; that is not the schedule's.)"""
    if log is None:
        return
    lock, left = threading.Lock(), [len(views)]

    def gone():
        with lock:
            left[0] -= 1
            if left[0] == 0:
                log.append(("free", key))
    for v in views:
        weakref.finalize(v, gone)


def fsdp_all_gather(local: Dict[str, torch.Tensor], layout: FsdpLayout,
                    mesh, axes: Sequence[str],
                    log: Optional[list] = None) -> PyTree:
    """Bucket-wise all-gather of the parameter shards, FULL params tree out
    (views of the gathered buffers, outside autograd). Buffers are
    gathered in FORWARD order (bucket 0 first), asynchronously, and waited
    on at the end. The leaves are leaf tensors (make them trainable in
    place with ``requires_grad_()``). `log` (a list) gets ``("ag", key)``
    per gather issued and ``("free", key)`` when its leaves have died."""
    group, _ = fsdp_group(mesh, axes, layout)
    out: List[Any] = [None] * layout.num_leaves
    works = []
    for g in layout.groups:
        full, work = _gather(local[g.key], group, layout.n_shards, True)
        if log is not None:
            log.append(("ag", g.key))
        works.append(work)
        _unpack_group(full, g, out)
        _logged_free(log, g.key, [out[i] for i in g.leaf_idx])
    for w in works:
        if w is not None:
            w.wait()
    return _rebuild(layout, out)


@torch.no_grad()
def grad_sync_fsdp(grads: PyTree, layout: FsdpLayout, mesh,
                   axes: Sequence[str], log: Optional[list] = None
                   ) -> Dict[str, torch.Tensor]:
    """Bucket-wise reduce-scatter of the gradients — the ZeRO-3 half of the
    HDOT schedule. One asynchronous reduce-scatter per flat buffer, ISSUED
    in reverse layout order (the head bucket's first: its gradients are
    complete earliest in the backward pass), all waited on before
    returning. Returns {key: local shard} of the SUM over the DP ranks
    (divide by the shard count for the mean). `log` gets ``("rs", key)``
    per reduce-scatter issued."""
    leaves = tree_leaves(grads)
    if len(leaves) != layout.num_leaves or tree_map(
            lambda _: None, grads) != layout.treedef:
        raise ValueError("gradient tree does not match the FSDP layout")
    group, _ = fsdp_group(mesh, axes, layout)
    out, works = {}, []
    for g in reversed(layout.groups):
        out[g.key], work = _scatter(_pack_group(leaves, g), group,
                                    layout.n_shards)
        if log is not None:
            log.append(("rs", g.key))
        works.append(work)
    for w in works:
        if w is not None:
            w.wait()
    return out


# ------------------------------------------------- streaming ZeRO-3 schedule
class _Materialize(torch.autograd.Function):
    """Forward: all-gather the shards of one depth's buffers (or take the
    gather prefetched for it) and return a view per leaf. Backward: pack
    the leaves' gradients into the buffers and reduce-scatter them into
    shard gradients — the port's form of JAX's AD transpose of a tiled
    ``all_gather`` into a tiled ``psum_scatter``. The reduce-scatters are
    asynchronous; the stream collects their results (:meth:`FsdpStream.
    finish`), so the backward returns no gradient for the shards."""

    @staticmethod
    def forward(ctx, stream, depth, *shards):
        ctx.stream, ctx.depth = stream, depth
        ctx.set_materialize_grads(False)
        out: List[Any] = [None] * stream.layout.num_leaves
        for g, full in zip(stream.groups_at(depth), stream._take(depth)):
            _unpack_group(full, g, out)
            _logged_free(stream.log, g.key, [out[i] for i in g.leaf_idx])
        ctx.idx = [i for g in stream.groups_at(depth) for i in g.leaf_idx]
        return tuple(out[i] for i in ctx.idx)

    @staticmethod
    def backward(ctx, *grads):
        stream = ctx.stream
        by_leaf = dict(zip(ctx.idx, grads))
        for g in reversed(stream.groups_at(ctx.depth)):   # layout order,
            # reversed, as grad_sync_fsdp issues them
            dt = torch_dtype(g.dtype)
            dev = stream.device
            leaves = [by_leaf[i] if by_leaf[i] is not None else
                      torch.zeros(s, dtype=dt, device=dev)
                      for i, s in zip(g.leaf_idx, g.shapes)]
            full = _pack_group(dict(zip(g.leaf_idx, leaves)), g)
            stream._reduce(g.key, full)
        return (None, None) + (None,) * len(stream.groups_at(ctx.depth))


class FsdpStream:
    """Gather/free schedule for streaming ZeRO-3: the layer→bucket map and
    the per-step collectives.

    Built from a per-layer layout (``order='layer'``) plus the same
    layer-provenance tree that cut it, it maps each forward depth to the
    flat buffers holding exactly that depth's parameters. The streamed loss
    calls :meth:`materialize` INSIDE each layer's remat region, so a
    bucket's all-gather is issued just before the one layer that consumes
    it, the gathered buffer dies at the end of that layer's forward, and
    the backward's recompute regathers it in REVERSE layer order; the
    backward of each gather issues the bucket's reduce-scatter,
    last-backward-first. Each gather prefetches the next stack layer's
    (forward order in the forward, reverse order in the backward), so at
    most two buckets' buffers are live with the head's; older
    reduce-scatters are waited on once ``working_set`` are in flight.

    Per step (one microbatch): :meth:`start` with the shards, the loss,
    :meth:`backward_phase`, ``loss.backward()``, then :meth:`finish`, which
    returns {key: shard gradient} of the SUM over the DP ranks. `log`
    records ``("ag" | "rs" | "free", key)`` in issue order."""

    def __init__(self, layout: FsdpLayout, layers: PyTree, mesh,
                 axes: Sequence[str], working_set: int = 2,
                 log: Optional[list] = None):
        tags = tree_leaves(layers)
        if len(tags) != layout.num_leaves:
            raise ValueError(
                f"layer-provenance tree has {len(tags)} leaves but the "
                f"layout packs {layout.num_leaves}")
        depth_groups: Dict[int, List[FsdpGroup]] = {}
        for g in layout.groups:
            ds = sorted({int(tags[i]) for i in g.leaf_idx})
            if len(ds) != 1:
                raise ValueError(
                    f"streaming ZeRO-3 needs per-layer buckets: buffer "
                    f"{g.key} spans forward depths {ds} — cut the layout "
                    "with order='layer'")
            depth_groups.setdefault(ds[0], []).append(g)
        self.layout, self.mesh, self.axes = layout, mesh, tuple(axes)
        self.depth_groups = tuple((d, tuple(depth_groups[d]))
                                  for d in sorted(depth_groups))
        self._by_depth = dict(self.depth_groups)
        self.group, _ = fsdp_group(mesh, self.axes, layout)
        self.working_set = working_set
        self.log = log
        self.device = None
        self._flat: Dict[str, torch.Tensor] = {}
        self._prefetched: Dict[int, tuple] = {}
        self._reduces: list = []
        self._grads: Dict[str, torch.Tensor] = {}
        self._seen: set = set()
        self.direction = 1

    @property
    def depths(self) -> Tuple[int, ...]:
        """Forward depths with parameters, shallowest first."""
        return tuple(d for d, _ in self.depth_groups)

    def groups_at(self, *depths: int) -> Tuple[FsdpGroup, ...]:
        return sum((self._by_depth.get(d, ()) for d in depths), ())

    def flat_at(self, pflat: Dict[str, torch.Tensor],
                *depths: int) -> Dict[str, torch.Tensor]:
        """The shard sub-dict feeding `depths`' remat region."""
        return {g.key: pflat[g.key] for g in self.groups_at(*depths)}

    # ------------------------------------------------------------ the step
    def start(self, pflat: Dict[str, torch.Tensor]) -> None:
        """Begin a microbatch's forward over the shards `pflat`."""
        self._flat = pflat
        self.device = next(iter(pflat.values())).device
        self._prefetched, self._reduces, self._grads = {}, [], {}
        self._seen = set()
        self.direction = 1

    def backward_phase(self) -> None:
        """The forward is done: gathers from here on are the backward's
        recompute, in reverse layer order."""
        self.direction = -1
        self._seen = set()

    def materialize(self, flat: Dict[str, torch.Tensor],
                    *depths: int) -> PyTree:
        """All-gather the buffers of `depths` and unpack them into a params
        tree with ``None`` holes everywhere else (views of the gathered
        buffers, differentiable: their gradients are reduce-scattered into
        the shards'). Call inside the consuming remat region."""
        out: List[Any] = [None] * self.layout.num_leaves
        for d in depths:
            groups = self.groups_at(d)
            views = _Materialize.apply(self, d,
                                       *(flat[g.key] for g in groups))
            idx = [i for g in groups for i in g.leaf_idx]
            for i, v in zip(idx, views):
                out[i] = v
        return _rebuild(self.layout, out)

    def _issue(self, depth: int) -> tuple:
        """Issue the gathers of one depth: ((full, work), ...)."""
        issued = []
        for g in self.groups_at(depth):
            full, work = _gather(self._flat[g.key], self.group,
                                 self.layout.n_shards, async_op=True)
            if self.log is not None:
                self.log.append(("ag", g.key))
            issued.append((full, work))
        return tuple(issued)

    def _next(self, depth: int) -> Optional[int]:
        """The depth to prefetch after `depth`: the next one forward (the
        head after the last layer, nothing after the head), or the previous
        stack layer in the backward (the embedding is not regathered)."""
        ds = self.depths
        k = ds.index(depth)
        if self.direction > 0:
            nxt = ds[k + 1] if k + 1 < len(ds) else None
        else:
            nxt = ds[k - 1] if 1 < k < len(ds) - 1 else None
        # a depth this direction has gathered already (a tied embedding's
        # second gather, at the head) prefetches nothing
        return None if nxt in self._seen else nxt

    def _take(self, depth: int) -> List[torch.Tensor]:
        """The gathered buffers of `depth` (prefetched or gathered now),
        after issuing the prefetch of the next depth (with a working set
        of 2 or more)."""
        issued = self._prefetched.pop(depth, None) or self._issue(depth)
        self._seen.add(depth)
        nxt = self._next(depth)
        if (nxt is not None and self.working_set > 1
                and nxt not in self._prefetched):
            self._prefetched[nxt] = self._issue(nxt)
        for _, work in issued:
            if work is not None:
                work.wait()
        return [full for full, _ in issued]

    def _reduce(self, key: str, full: torch.Tensor) -> None:
        """Issue one buffer's reduce-scatter; wait on the oldest once more
        than ``working_set`` are in flight."""
        out, work = _scatter(full, self.group, self.layout.n_shards)
        if self.log is not None:
            self.log.append(("rs", key))
        self._reduces.append((key, out, work, full))
        while len(self._reduces) > self.working_set:
            self._land(*self._reduces.pop(0))

    def _land(self, key, out, work, full) -> None:
        if work is not None:
            work.wait()
        prev = self._grads.get(key)
        # a buffer gathered twice (a tied embedding) sums its two
        # reduce-scatters, in issue order
        self._grads[key] = out if prev is None else prev + out

    @torch.no_grad()
    def finish(self) -> Dict[str, torch.Tensor]:
        """Wait on what is in flight; {key: shard gradient}, the SUM over
        the DP ranks, zeros for a buffer the loss did not reach."""
        while self._reduces:
            self._land(*self._reduces.pop(0))
        grads = {k: self._grads.get(k) for k in self.layout.keys}
        for k, v in grads.items():
            if v is None:
                grads[k] = torch.zeros_like(self._flat[k])
        self._flat, self._grads, self._prefetched = {}, {}, {}
        return grads


def fsdp_stream(layout: FsdpLayout, layers: PyTree, mesh,
                axes: Sequence[str], working_set: int = 2,
                log: Optional[list] = None) -> FsdpStream:
    """Build the streaming gather/free schedule from a per-layer layout and
    its layer-provenance tree. Every buffer must cover exactly ONE forward
    depth (build the layout with ``order='layer'``)."""
    return FsdpStream(layout, layers, mesh, axes, working_set, log)
