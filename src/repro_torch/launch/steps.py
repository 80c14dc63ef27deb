"""The data-parallel, tensor-parallel and ZeRO-3 train steps: the port of
the train half of ``repro/launch/steps.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. On a DP-only mesh the gradient sum over the DP axes
is the explicit schedule of ``core/overlap.py``: ``ParallelConfig.overlap``
picks the HDOT buckets issued during the backward (:class:`GradBuckets`) or
the monolithic two-phase baseline after it. Without a mesh (or on a mesh
whose DP replicas are one rank) the gradients are the plain accumulation.

On a mesh whose "model" axis (``ParallelConfig.tp_axis``) has more than one
rank, ``make_train_step`` returns the tensor-parallel step
(:func:`make_tp_train_step`, every family; the MoE blocks under expert
parallelism, each all-to-all in ``moe_a2a_chunks`` slices): the
parameters and AdamW moments at rest are this rank's blocks under
``rules_for("train")`` (:class:`TPPlan`), the forward and backward run
the Megatron cut with sequence parallelism (:mod:`repro_torch.sharding.
tp`), and where the JAX package leaves every collective to GSPMD, the
step issues them itself.

``make_fsdp_train_step`` is the ZeRO-3 composition
(``ParallelConfig.param_shard``): params and AdamW moments live as
bucket-wise flat buffers sharded over the DP ranks (:func:`fsdp_init_state`,
one bucket at a time), gathered all at the top of the step and
reduce-scattered last-backward-first, or, with ``fsdp_streaming``, gathered
layer by layer inside each layer's remat region (``FsdpStream``).

The serve half: ``make_prefill_step``, ``make_decode_step``,
``opt_state_specs``, ``Cell`` and ``build_cell`` (the reference's cells:
abstract args as meta-device tensors, their logical axes and donation),
and, where the reference jits a cell with ``in_shardings`` and lets GSPMD
place it, :func:`cell_step`: the cell on a ("data", "model") or ("pod",
"data", "model") mesh, each rank holding only its blocks of the
parameters and caches under ``rules_for(cell.kind)`` (:class:`ServePlan`)
and issuing every collective itself. ``Cell.lower`` is the dry run's
lowering: this rank's step on fake blocks (:class:`Lowered`), whose
``compile()`` runs it once under fake tensors and answers the reference's
``cost_analysis()`` and ``memory_analysis()`` (``analysis/fake_run.py``,
:class:`Compiled`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ParallelConfig
from repro_torch.config.shapes import ShapeConfig
from repro_torch.core.overlap import (FsdpLayout, GradBuckets, _pack_group,
                                      accumulate_grads, fsdp_all_gather,
                                      fsdp_group, fsdp_layout, fsdp_stream,
                                      grad_sync_fsdp, grad_sync_two_phase,
                                      microbatch_split, pmean, shard_slice,
                                      value_and_grad)
from repro_torch.checkpoint.elastic import (Sharding, _map2, block_index,
                                            cut, shardings_for, unshard_leaf)
from repro_torch.launch.mesh import coords_rank
from repro_torch.models.layers import (ParamTree, axes_from_specs, init_leaf,
                                      leaf_paths, rebuild, tree_leaves,
                                      tree_map)
from repro_torch.models.model import (LanguageModel, ModelOptions,
                                     build_model, input_specs)
from repro_torch.models.transformer import _not_ported, is_unrolled
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.runtime.tracing import span, step_bwd
from repro_torch.sharding.rules import (ShardingContext, entry_axes,
                                        resolve_pspec, rules_for)
from repro_torch.sharding.tp import (ServeCut, TPCut, all_gather,
                                     block_order, gather_dim,
                                     global_norm_by_class, grad_all_reduce,
                                     take_rows)

PyTree = Any


def tp_size(parallel: ParallelConfig, mesh) -> int:
    """The rank count of the mesh's TP axis (1 without a mesh or axis)."""
    if mesh is None:
        return 1
    return mesh.shape.get(parallel.tp_axis, 1)


def check_ported(parallel: ParallelConfig, mesh=None) -> None:
    """Raise for what the train steps do not honour. ZeRO-3 needs an
    explicit DP-only mesh (``ValueError``, as in the JAX package: it never
    quietly replicates, so ``param_shard`` with a TP axis raises too);
    ``NotImplementedError`` for a non-DP axis of more than one rank other
    than the TP axis. Every family trains on a TP axis; ``moe_a2a_chunks``
    is read only where the MoE blocks run expert parallelism (a TP axis of
    more than one rank), as in the JAX package, and a mesh without one
    ignores it. ``collective_matmul`` and ``grad_compression`` are read
    nowhere, as in the JAX package, whose trainer trains the same step
    with either set (the TP rings serve decode: ``models/decode_tp.py``;
    the int8 codec serves ``core/reduction.py``'s staged all-reduce)."""
    if parallel.param_shard:
        _require_explicit_mesh(parallel, mesh)
    if mesh is not None:
        other = {a: s for a, s in mesh.shape.items()
                 if a not in parallel.dp_axes and a != parallel.tp_axis
                 and s > 1}
        if other:
            raise _not_ported(f"a mesh with non-DP, non-TP axes of size > 1 "
                              f"{other}")


def explicit_sync_axes(parallel: ParallelConfig, mesh
                       ) -> Tuple[Tuple[str, ...], bool]:
    """(sync_axes, explicit): the DP axes present on `mesh`, and whether the
    explicit grad-sync schedules are faithful there (every non-DP mesh
    axis trivial)."""
    if mesh is None:
        return (), False
    sync_axes = tuple(a for a in parallel.dp_axes if a in mesh.axis_names)
    explicit = bool(sync_axes) and all(
        mesh.shape[a] == 1 for a in mesh.axis_names if a not in sync_axes)
    return sync_axes, explicit


def make_train_step(model: LanguageModel, parallel: ParallelConfig,
                    opt_cfg: Optional[AdamWConfig] = None,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    mesh=None, params: Optional[PyTree] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), params
    and moments updated in place; metrics are 0-d tensors ("loss",
    "grad_norm", "lr"). `batch` holds this rank's rows.

    The HDOT schedule (``parallel.overlap == "hdot"`` on an explicit mesh)
    hooks the parameters it is built for: pass them as `params`, and step
    those same tensors. On a mesh with a TP axis of more than one rank it
    is :func:`make_tp_train_step` (the params are then this rank's
    blocks)."""
    check_ported(parallel, mesh)
    if tp_size(parallel, mesh) > 1:
        return make_tp_train_step(model, parallel, mesh, opt_cfg,
                                  warmup_steps, total_steps)
    opt_cfg = opt_cfg or AdamWConfig()
    accum = parallel.accum_steps
    sync_axes, explicit = explicit_sync_axes(parallel, mesh)
    n_shards = math.prod(mesh.shape[a] for a in sync_axes) if explicit else 1
    # layer provenance: cut buckets on layer boundaries and issue them
    # last-backward-first (ParallelConfig.bucket_order)
    layers = (model.param_layers()
              if parallel.bucket_order == "reverse_topo" else None)
    buckets = None
    if explicit and parallel.overlap == "hdot":
        if params is None:
            raise ValueError("the hdot step needs the parameters it hooks")
        buckets = GradBuckets(params, mesh, sync_axes, parallel.grad_buckets,
                              layers, parallel.bucket_order, accum)
    elif parallel.overlap not in ("hdot", "two_phase", "none"):
        raise ValueError(f"unknown overlap mode {parallel.overlap!r}")
    loss_and_grad = value_and_grad(model.train_loss)

    def hdot_grads(params, batch):
        buckets.start()
        split = microbatch_split(batch, accum)
        micro = [tree_map(lambda x: x[j], split) for j in range(accum)]
        loss_acc = 0.0
        for j, mb in enumerate(micro):
            buckets.last = j == accum - 1
            with span("step.fwd"):
                loss = model.train_loss(params, mb)
            step_bwd(loss).backward()
            loss_acc = loss_acc + loss.detach().float()
        loss = loss_acc if accum == 1 else loss_acc * (1.0 / accum)
        return loss, buckets.finish()

    def two_phase_grads(params, batch):
        loss, grads = accumulate_grads(loss_and_grad, params, batch, accum)
        if explicit:
            grads = grad_sync_two_phase(grads, mesh, sync_axes)
            if n_shards > 1:
                for g in tree_leaves(grads):
                    g.div_(n_shards)
        return loss, grads

    grads_fn = hdot_grads if buckets is not None else two_phase_grads

    def step_fn(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        if explicit:
            loss = pmean(loss, mesh, sync_axes)
        lr = warmup_cosine(opt_state["step"], opt_cfg.lr, warmup_steps,
                           total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    step_fn.buckets = buckets
    return step_fn


# -------------------------------------------------------------- train (TP)
class TPPlan:
    """The placement of one model's training state on a mesh with a TP
    axis: every leaf's spec under ``rules_for("train")`` (the JAX Trainer's
    ``DEFAULT_RULES``) and this rank's block of it, and what the step does
    with each leaf.

    The DP axes place only "embed" dims (FSDP over ("pod", "data")); the
    TP axis places "heads", "kv_heads", "mlp", "vocab" and "experts" (an
    expert leaf's "expert_mlp" then stays whole: the axis is taken), or,
    where the experts do not divide it, "expert_mlp" (expert TP: every
    expert's columns of the rank). The
    expert leaves are blocks of the TP axis, so their gradients are not
    all-reduced over it; the router, ``("embed", None)``, is FSDP over the
    DP axes and replicated on the TP axis, its gradient a partial sum over
    the rank's tokens, all-reduced like a norm weight's.
    :meth:`gather_data` all-gathers the data-placed dims (its backward
    reduce-scatters the gradient over the DP replicas) and marks the DP
    axes a leaf is replicated on (its gradient all-reduced there): the
    leaf becomes its TP block, at the top of a step for the leaves
    outside the layer stack and inside each layer's remat region for the
    stack's (:meth:`layer_view`). Per microbatch :meth:`model_view` gathers
    the vocab-placed tables over the TP axis (the backward reduce-scatters
    onto the rank's vocab block) and marks the leaves the TP axis
    replicates (norm weights, ``q_norm``/``k_norm``, and whatever the rules
    fall back to replicating: their gradients are partial sums over the
    ranks' tokens or heads, all-reduced). Building a plan creates the
    process groups it uses, so every rank of the mesh builds it, in the
    same order."""

    def __init__(self, model: LanguageModel, parallel: ParallelConfig, mesh):
        self.mesh = mesh
        self.ctx = ShardingContext(mesh, rules_for("train"))
        self.spec_tree = model.param_specs()
        specs = leaf_paths(self.spec_tree)
        self.paths, self.specs = list(specs), list(specs.values())
        self.data_axes = tuple(a for a in parallel.dp_axes
                               if a in mesh.axis_names)
        self.dp = math.prod(mesh.shape[a] for a in self.data_axes)
        # this rank's DP replica, pod-major over the DP axes
        self.dp_index = coords_rank(
            [mesh.coords[mesh.axis_index(a)] for a in self.data_axes],
            [mesh.shape[a] for a in self.data_axes])
        self.axis = parallel.tp_axis
        self.tp = mesh.shape[self.axis]
        self.shardings, self.classes = [], []
        self._data, self._model = [], []
        for spec in self.specs:
            pspec = resolve_pspec(spec.shape, spec.axes, self.ctx)
            self.shardings.append(Sharding(tuple(spec.shape), pspec,
                                           block_index(spec.shape, pspec,
                                                       mesh)))
            placed = [(d, entry_axes(e)) for d, e in enumerate(pspec) if e]
            data = [(d, ax) for d, ax in placed
                    if all(a in self.data_axes for a in ax)]
            mdims = [d for d, ax in placed if ax == (self.axis,)]
            if len(data) + len(mdims) != len(placed):
                raise ValueError(f"placement {pspec} of {spec.axes} mixes "
                                 f"the DP axes {self.data_axes} and "
                                 f"{self.axis!r} on one dim")
            used = {a for _, ax in data for a in ax}
            rest = tuple(a for a in self.data_axes
                         if a not in used and mesh.shape[a] > 1)
            self._data.append((data, rest))
            vocab = [d for d in mdims if spec.axes[d] == "vocab"]
            self._model.append((bool(mdims), vocab))
            axes = {a for _, ax in placed for a in ax}
            self.classes.append(tuple(a for a in mesh.axis_names
                                      if a in axes))
        # the layer stack's leaves, gathered per layer by :meth:`layer_view`
        self.index = {p: i for i, p in enumerate(self.paths)}
        self.scanned = not is_unrolled(self.spec_tree["layers"])
        self.stack = frozenset(i for i, p in enumerate(self.paths)
                               if p[0] == "layers")
        for i in self.stack:
            if self.scanned and any(d == 0 for d, _ in self._data[i][0]):
                raise ValueError(f"leaf {self.paths[i]}: the rules place "
                                 f"its scanned layer dim")
        # every group the step uses, created in one order on every rank
        for data, rest in self._data:
            for _, ax in data:
                mesh.axes_group(ax)
            mesh.axes_group(rest)
        for cls in sorted(set(self.classes)):
            mesh.axes_group(cls)
        mesh.axes_group(tuple(mesh.axis_names))
        self.cut = TPCut.for_model(model.cfg, mesh, self.ctx, self.axis)

    def block(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf `i` (a copy)."""
        return cut(full, self.shardings[i])

    def gather_data(self, i: int, w: torch.Tensor, shift: int = 0
                    ) -> torch.Tensor:
        """Leaf `i`'s TP block from `w`, this rank's block of it, or with
        `shift` 1 of one layer of it (a scanned leaf without its layer
        dim)."""
        data, rest = self._data[i]
        for d, ax in data:
            w = all_gather(w, d - shift, self.mesh, ax)
        return grad_all_reduce(w, self.mesh, rest) if rest else w

    def layer_view(self, i: int, p_l) -> PyTree:
        """Layer `i`'s parameters as the cut reads them, from `p_l`, its
        tree of this rank's blocks (of a scanned stack: their layer-`i`
        slices): every leaf through :meth:`gather_data` and
        :meth:`model_view`. The train step calls it inside the layer's
        remat region (``stack_apply``'s `stream`)."""
        prefix = ("layers",) if self.scanned else ("layers", i)
        shift = int(self.scanned)
        out = {}
        for sub, w in leaf_paths(p_l).items():
            k = self.index[prefix + sub]
            out[sub] = self.model_view(k, self.gather_data(k, w, shift))
        return rebuild(p_l, out)

    def model_view(self, i: int, w: torch.Tensor) -> torch.Tensor:
        sharded, vocab = self._model[i]
        if not sharded:
            return grad_all_reduce(w, self.mesh, (self.axis,))
        for d in vocab:
            w = all_gather(w, d, self.mesh, (self.axis,))
        return w

    def init_state(self, seed: int = 0, params: Optional[PyTree] = None,
                   device="cuda") -> Tuple[ParamTree, PyTree]:
        """This rank's blocks (trainable) and zero float32 AdamW moments of
        their shapes. Each leaf is drawn from its path's seed
        (``models.layers.init_leaf``), or taken from `params` (a full
        tree), and cut before the next: the full tree never exists on a
        rank, only one full leaf at a time."""
        given = None if params is None else tree_leaves(params)
        blocks = {}
        for i, (path, spec) in enumerate(zip(self.paths, self.specs)):
            full = (init_leaf(seed, path, spec, device) if given is None
                    else given[i].detach().to(device, spec.dtype))
            blocks[path] = self.block(i, full)
            del full
        tree = ParamTree(rebuild(self.spec_tree, blocks))
        tree.requires_grad_(True)
        return tree, adamw_init(tree)


def make_tp_train_step(model: LanguageModel, parallel: ParallelConfig, mesh,
                       opt_cfg: Optional[AdamWConfig] = None,
                       warmup_steps: int = 100, total_steps: int = 10_000,
                       plan: Optional[TPPlan] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics) on a mesh
    with a TP axis: `params` and the moments are this rank's blocks
    (:meth:`TPPlan.init_state`), updated in place; `batch` holds the rows
    of this rank's DP replica (every rank of a model line the same).

    The step gathers the data-placed dims (:meth:`TPPlan.gather_data`)
    of the leaves outside the layer stack at its top: the embedding (a
    tied one serves the head from the same gathered table, its two
    gradients summed there before one reduce-scatter), the head, the
    final norm, Whisper's encoder and audio projection, LLaVA's vision
    projection. Each layer's leaves are gathered inside that layer's
    remat region (:meth:`TPPlan.layer_view`, ``stack_apply``'s
    `stream`, scanned or unrolled): the gathered blocks die after the
    layer's forward, the backward's recompute gathers them again in
    reverse layer order, and each gather's backward reduce-scatters the
    layer's gradient onto this rank's blocks as soon as that layer's
    backward ends, once a microbatch. Each of ``accum_steps``
    microbatches runs its forward and backward under the cut
    (``train_loss(..., tp)``, each rank's loss over its own rows divided
    by the TP rank count, so a model line's losses sum to its mean; the
    MoE aux loss, the same on every rank, enters each rank's loss whole,
    so the line counts it once). The gradients accumulate (in float32
    over several microbatches) on this rank's blocks of the layers, and on
    the gathered leaves of the others, which go back through their gathers
    once after the last microbatch: each rank holds the gradient of its
    own block, summed over every rank that touched it, divided by the DP
    replica count as the DP step does. The grad norm counts unique
    elements only (one all-reduce of square sums per placement class,
    over the axes that shard it); AdamW runs on the blocks. The loss is the mean over every
    token (one all-reduce). ``parallel.overlap`` is read nowhere here, as
    in the JAX package, where the partitioner schedules the
    reductions."""
    check_ported(parallel, mesh)
    opt_cfg = opt_cfg or AdamWConfig()
    plan = plan or TPPlan(model, parallel, mesh)
    inv_tp = 1.0 / plan.tp
    stack = plan.stack

    def loss_and_grad(xs, batch):
        view = {p: x if i in stack else plan.model_view(i, x)
                for i, (p, x) in enumerate(zip(plan.paths, xs))}
        loss = model.train_loss(rebuild(plan.spec_tree, view), batch,
                                tp=plan.cut, stream=plan.layer_view)
        return loss.detach(), list(torch.autograd.grad(loss * inv_tp, xs))

    def step_fn(params, opt_state, batch):
        leaves = tree_leaves(params)
        top = {i: plan.gather_data(i, w) for i, w in enumerate(leaves)
               if i not in stack}
        loss, acc = accumulate_grads(
            loss_and_grad,
            [w if i in stack else top[i].detach().requires_grad_()
             for i, w in enumerate(leaves)],
            batch, parallel.accum_steps)
        grads = []
        for i, (w, a) in enumerate(zip(leaves, acc)):
            f = top.get(i)
            if f is not None and f is not w:   # back through the gather
                a = torch.autograd.grad(f, w, a.to(f.dtype))[0]
            grads.append(a.div_(plan.dp) if plan.dp > 1 else a)
        del top, acc
        loss = pmean(loss, mesh, mesh.axis_names)
        gnorm = global_norm_by_class(grads, plan.classes, mesh)
        lr = warmup_cosine(opt_state["step"], opt_cfg.lr, warmup_steps,
                           total_steps)
        params, opt_state, gnorm = adamw_update(
            rebuild(plan.spec_tree, dict(zip(plan.paths, grads))), opt_state,
            params, opt_cfg, lr, gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    step_fn.buckets = None
    step_fn.plan = plan
    return step_fn


# ------------------------------------------------------------ train (ZeRO-3)
def _require_explicit_mesh(parallel: ParallelConfig, mesh) -> Tuple[str, ...]:
    """sync_axes, or a loud error when the mesh cannot host the explicit
    ZeRO-3 step (a non-trivial TP axis would replicate the flat shards'
    layer math). Single source for the param_shard precondition."""
    sync_axes, explicit = explicit_sync_axes(parallel, mesh)
    if not explicit:
        raise ValueError(
            "param_shard=True needs the explicit-schedule step: a mesh whose "
            f"non-DP axes are all trivial (got mesh axes "
            f"{mesh.shape if mesh is not None else None}, "
            f"dp_axes {parallel.dp_axes})")
    return sync_axes


def fsdp_layout_for(model: LanguageModel, parallel: ParallelConfig,
                    mesh) -> Tuple[FsdpLayout, Tuple[str, ...]]:
    """The bucket-wise flat-buffer layout of `model`'s params for ZeRO-3
    sharding over the mesh's DP axes (layer-boundary buckets when
    ``parallel.bucket_order == 'reverse_topo'``; one bucket PER layer when
    ``parallel.fsdp_streaming``, so each gather has a single consuming
    layer)."""
    sync_axes = _require_explicit_mesh(parallel, mesh)
    n_shards = math.prod(mesh.shape[a] for a in sync_axes)
    order = "layer" if parallel.fsdp_streaming else parallel.bucket_order
    layers = (model.param_layers()
              if order in ("reverse_topo", "layer") else None)
    layout = fsdp_layout(model.param_specs(), n_shards,
                         parallel.grad_buckets, layers=layers, order=order)
    return layout, sync_axes


def fsdp_init_state(model: LanguageModel, parallel: ParallelConfig, mesh,
                    seed: int = 0, params: Optional[PyTree] = None
                    ) -> Tuple[Dict[str, torch.Tensor], PyTree, FsdpLayout]:
    """The ZeRO-3 trainer state on this rank: its shard of every flat
    parameter buffer (trainable) and zero float32 AdamW moments of the same
    shape, on the mesh's device. Returns (params_flat, opt_state, layout).

    Init is SHARDED per bucket: each buffer's leaves are drawn from their
    paths' seeds (``models.layers.init_leaf``), packed, and cut to this
    rank's shard before the next bucket is drawn, so the full tree never
    exists on one card: transient bytes stay within one bucket.
    Bit-identical to initialising the full tree and sharding it, since each
    leaf's seed derives from its tree path. With `params` (a full tree, e.g.
    from ``params_from_jax``), that tree is sharded instead."""
    layout, sync_axes = fsdp_layout_for(model, parallel, mesh)
    _, index = fsdp_group(mesh, sync_axes, layout)
    dev = mesh.device
    specs = list(leaf_paths(model.param_specs()).items())
    given = None if params is None else tree_leaves(params)
    flat = {}
    for g in layout.groups:
        leaves: Dict[int, torch.Tensor] = {}
        for i in g.leaf_idx:
            path, spec = specs[i]
            leaves[i] = (init_leaf(seed, path, spec, dev) if given is None
                         else given[i].detach().to(dev, spec.dtype))
        flat[g.key] = shard_slice(_pack_group(leaves, g), layout.n_shards,
                                  index).clone().requires_grad_()
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
             for k, v in flat.items()}
    opt = {"m": zeros, "v": {k: torch.zeros_like(v) for k, v in zeros.items()},
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return flat, opt, layout


def make_fsdp_train_step(model: LanguageModel, parallel: ParallelConfig, mesh,
                         opt_cfg: Optional[AdamWConfig] = None,
                         warmup_steps: int = 100, total_steps: int = 10_000,
                         layout: Optional[FsdpLayout] = None,
                         log: Optional[list] = None) -> Callable:
    """(params_flat, opt_state, batch) -> (params_flat, opt_state, metrics):
    the FSDP (ZeRO-3) composition of the explicit HDOT grad-sync schedule,
    shards and moments updated in place. `batch` holds this rank's rows.

    Gather-all: bucket-wise all-gather of the flat parameter shards in
    FORWARD order, loss/backward on the gathered params, then a bucket-wise
    reduce-scatter ISSUED reverse-topologically (``grad_sync_fsdp``). With
    ``parallel.fsdp_streaming`` the gather-all is replaced by the streaming
    schedule (``FsdpStream``, ``train_loss_streamed``): per-layer buckets
    gathered inside each layer's remat region, freed after its forward,
    regathered in reverse order by the backward, whose gathers issue the
    per-bucket reduce-scatters last-backward-first. The mean gradient is
    the reduce-scatter's sum over n_shards; the loss is the mean over the
    DP ranks. AdamW then runs on the flat shards, its clip norm all-reduced
    over the DP group. `log` (a list) records the collectives in issue
    order (``("ag" | "rs" | "free", key)``, see ``core/overlap.py``). The
    step's ``stream`` attribute is the ``FsdpStream`` (None gathering
    all)."""
    opt_cfg = opt_cfg or AdamWConfig()
    accum = parallel.accum_steps
    if layout is None:
        layout, sync_axes = fsdp_layout_for(model, parallel, mesh)
    else:
        sync_axes = _require_explicit_mesh(parallel, mesh)
    group, _ = fsdp_group(mesh, sync_axes, layout)
    n_shards = layout.n_shards
    stream = None

    if parallel.fsdp_streaming:
        stream = fsdp_stream(layout, model.param_layers(), mesh, sync_axes,
                             parallel.fsdp_working_set, log)

        def loss_and_grad(pflat, batch):
            stream.start(pflat)
            loss = model.train_loss_streamed(pflat, batch, stream)
            stream.backward_phase()
            loss.backward()
            return loss.detach(), stream.finish()
    else:
        def loss_and_grad(pflat, batch):
            params = fsdp_all_gather(pflat, layout, mesh, sync_axes, log)
            params = tree_map(lambda p: p.requires_grad_(), params)
            loss, grads = value_and_grad(model.train_loss)(params, batch)
            del params
            return loss, grad_sync_fsdp(grads, layout, mesh, sync_axes, log)

    def step_fn(pflat, opt_state, batch):
        loss, gflat = accumulate_grads(loss_and_grad, pflat, batch, accum)
        # reduce-scatter of per-shard mean-grads -> the global mean
        gflat = {k: v / n_shards for k, v in gflat.items()}
        loss = pmean(loss, mesh, sync_axes)
        lr = warmup_cosine(opt_state["step"], opt_cfg.lr, warmup_steps,
                           total_steps)
        pflat, opt_state, gnorm = adamw_update(gflat, opt_state, pflat,
                                               opt_cfg, lr, group=group)
        return pflat, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    step_fn.buckets = None
    step_fn.stream = stream
    return step_fn


# --------------------------------------------------------------------- serve
def make_prefill_step(model: LanguageModel) -> Callable:
    """(params, batch, max_len=None) -> (logits, caches): ``model.prefill``
    on one rank. `max_len` sizes the rings for the decode that follows
    (the reference's cell sizes them to the prompt)."""
    def prefill_fn(params, batch, max_len=None):
        return model.prefill(params, batch, max_len)

    return prefill_fn


def make_decode_step(model: LanguageModel) -> Callable:
    """(params, caches, token, pos) -> (logits, caches): ``model.
    decode_step`` on one rank."""
    def decode_fn(params, caches, token, pos):
        logits, new_caches = model.decode_step(params, token, caches, pos)
        return logits, new_caches

    return decode_fn


# ---------------------------------------------------------------- cell build
def opt_state_specs(model: LanguageModel, moment_dtype=torch.float32
                    ) -> Tuple[PyTree, PyTree]:
    """(abstract opt state, logical axes) matching ``adamw_init(params)``:
    meta-device moments in `moment_dtype`, an int32 step."""
    p_axes = model.param_axes()

    def mom():
        return tree_map(lambda s: torch.empty(s.shape, dtype=moment_dtype,
                                              device="meta"),
                        model.abstract_params())
    specs = {"m": mom(), "v": mom(),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    axes = {"m": p_axes, "v": p_axes, "step": ()}
    return specs, axes


@dataclasses.dataclass
class Cell:
    """One unit of work: ``fn(*args)`` with the abstract args (meta-device
    tensors), their logical axes and donation, the port of the
    reference's ``Cell``. ``fn`` runs on one rank; :func:`cell_step` is
    the counterpart of calling the jitted cell on a mesh: it takes and
    returns each rank's blocks under :attr:`rules`; :meth:`lower` is the
    dry run's."""

    name: str
    fn: Callable
    arg_specs: Tuple[PyTree, ...]       # meta-tensor trees (positional)
    arg_axes: Tuple[PyTree, ...]        # logical-axes trees (same structure)
    donate_argnums: Tuple[int, ...]
    model: LanguageModel
    kind: str                           # train | prefill | decode
    shape: Optional[ShapeConfig] = None
    parallel: Optional[ParallelConfig] = None

    @property
    def rules(self):
        return rules_for(self.kind, self.model.cfg.d_model,
                         self.model.cfg.family)

    def context(self, mesh) -> ShardingContext:
        return ShardingContext(mesh, self.rules)

    def in_specs(self, mesh) -> Tuple[PyTree, ...]:
        """The resolved PartitionSpec of every arg leaf on `mesh` (any
        object the rules resolve over, a fake mesh included)."""
        ctx = self.context(mesh)
        return tuple(_map2(lambda leaf, ax: resolve_pspec(leaf.shape, ax,
                                                          ctx), s, a)
                     for s, a in zip(self.arg_specs, self.arg_axes))

    def in_shardings(self, mesh) -> Tuple[PyTree, ...]:
        """Every arg leaf's :class:`~repro_torch.checkpoint.elastic.
        Sharding` (spec and this rank's block) on a ProcessMesh."""
        ctx = self.context(mesh)
        return tuple(shardings_for(s, a, mesh, ctx)
                     for s, a in zip(self.arg_specs, self.arg_axes))

    def lower(self, mesh) -> "Lowered":
        """The dry run's counterpart of ``jax.jit(fn, in_shardings=...)
        .lower(*arg_specs)``: this rank's step on `mesh` (a ProcessMesh over
        a real or a fake process group) with fake tensors (no data, no
        storage) for its blocks of every argument, each made directly in
        its block's shape from :meth:`in_shardings` (no whole leaf is
        made). The step is the rank's part of the cell: a train cell's
        :func:`make_tp_train_step` where the mesh's TP axis has more than
        one rank (``fn`` itself on one rank), a serving cell's
        :func:`cell_step`. ``compile()`` runs it once (:class:`Compiled`).
        Fake CPU tensors take the scans' plain versions (``ref.py``), as
        the reference's dry run on XLA-CPU takes ``impl="auto"``'s
        reference."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode(allow_non_fake_inputs=True)
        shardings = self.in_shardings(mesh)
        with mode:
            # a train cell's parameters are trainable
            args = tuple(
                _map2(lambda leaf, sh, grad=self.kind == "train" and i == 0:
                      torch.empty(_shape(sh), dtype=leaf.dtype)
                      .requires_grad_(grad), spec, sh)
                for i, (spec, sh) in enumerate(zip(self.arg_specs,
                                                   shardings)))
        return Lowered(self._rank_step(mesh, shardings), args, mode, mesh)

    def _rank_step(self, mesh, shardings) -> Callable:
        if self.kind != "train":
            step = cell_step(self, mesh)
            if self.kind == "prefill":
                return step
            # the decode step takes a scalar position: the ring's last slot
            pos = self.shape.seq_len - 1
            return lambda params, caches, token, _pos: step(params, caches,
                                                            token, pos)
        parallel = self.parallel or ParallelConfig()
        if tp_size(parallel, mesh) == 1:
            if mesh.size > 1:
                raise ValueError(
                    f"the dry run lowers a train cell on one rank or on a "
                    f"mesh whose {parallel.tp_axis!r} axis has more than one "
                    f"(got {mesh.shape})")
            return self.fn
        fn = make_tp_train_step(self.model, parallel, mesh)
        axis = parallel.tp_axis
        batch_sh = shardings[2]

        def step(params, opt_state, batch):
            # the TP step takes its DP replica's whole rows: the tokens'
            # blocks along "model" are gathered (the rules put "seq" there)
            rows = {}
            for k, x in batch.items():
                for d, entry in enumerate(batch_sh[k].spec):
                    part, _ = _model_part(entry, axis)
                    if part:
                        x = all_gather(x, d, mesh, part)
                rows[k] = x
            return fn(params, opt_state, rows)
        return step


@dataclasses.dataclass
class Lowered:
    """A cell's rank step on fake blocks (:meth:`Cell.lower`)."""

    step: Callable
    args: Tuple[PyTree, ...]
    fake_mode: object
    mesh: Any = None

    def compile(self) -> "Compiled":
        """One pass of the step under the fake tensors, counted
        (``analysis.fake_run.fake_pass``; the collectives by the mesh
        axes of their groups)."""
        from repro_torch.analysis.fake_run import fake_pass

        return Compiled(fake_pass(self.step, self.args, self.fake_mode,
                                  self.mesh))


@dataclasses.dataclass
class Compiled:
    """What the fake pass of a lowered cell counted, under the names the
    reference's compiled artifact answers to."""

    run: Any

    def cost_analysis(self) -> Dict[str, float]:
        """{"flops", "bytes accessed"}: the FLOPs of the rank's step
        (forward and backward) and the bytes of every non-view aten op's
        inputs and outputs (unfused: an upper bound)."""
        return {"flops": self.run.flops,
                "bytes accessed": self.run.bytes_accessed}

    def memory_analysis(self):
        """``analysis.fake_run.MemoryStats``: argument, output, alias and
        temp bytes of the rank's step, from the live storages."""
        return self.run.memory

    def collectives(self):
        """``analysis.fake_run.CollectiveSummary`` of the step's
        collectives, backward ones included."""
        return self.run.collectives

    def op_counts(self) -> Dict[str, int]:
        return dict(self.run.op_counts)

    notes = ("fake cpu tensors: the scans and attention take their plain "
             "versions")


def build_cell(cfg, shape: ShapeConfig, options: Optional[ModelOptions] = None,
               parallel: Optional[ParallelConfig] = None,
               moment_dtype=torch.float32) -> Cell:
    """The cell of (arch, shape), as the reference's ``build_cell``: its
    default options take ``"dense"`` attention up to 8192 tokens and
    ``"blockwise"`` above, the stack layout, remat and MoE all-to-all
    chunks of `parallel`."""
    parallel = parallel or ParallelConfig()
    options = options or ModelOptions(
        attn_impl="blockwise" if shape.seq_len > 8192 else "dense",
        scan_layers=parallel.scan_layers, remat=parallel.remat,
        moe_a2a_chunks=parallel.moe_a2a_chunks)
    model = build_model(cfg, options)
    io = input_specs(cfg, shape, options)
    batch_specs, batch_axes = io["specs"], io["axes"]
    p_abs = model.abstract_params()
    p_axes = model.param_axes()
    name = f"{cfg.name}:{shape.name}"
    if shape.kind == "train":
        o_abs, o_axes = opt_state_specs(model, moment_dtype)
        return Cell(name, make_train_step(model, parallel),
                    (p_abs, o_abs, batch_specs), (p_axes, o_axes, batch_axes),
                    (0, 1), model, "train", shape, parallel)
    if shape.kind == "prefill":
        return Cell(name, make_prefill_step(model), (p_abs, batch_specs),
                    (p_axes, batch_axes), (), model, "prefill", shape,
                    parallel)
    return Cell(name, make_decode_step(model),
                (p_abs, batch_specs["caches"], batch_specs["token"],
                 batch_specs["pos"]),
                (p_axes, batch_axes["caches"], batch_axes["token"],
                 batch_axes["pos"]), (1,), model, "decode", shape, parallel)


# -------------------------------------------------------- serve (the cut)
def serve_groups(mesh) -> None:
    """Creates, in one fixed order, every process group the serving cells
    use on `mesh` (``dist.new_group`` is collective: every rank calls
    this, in the same order)."""
    names = mesh.axis_names
    for axes in (("pod", "data"), ("model", "data"), ("model", "pod"),
                 ("model", "pod", "data")):
        axes = tuple(a for a in axes if a in names)
        if len(axes) > 1:
            mesh.axes_group(axes)


def _model_part(entry, axis: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the `axis` part, the other axes) of a spec entry. `axis` must be
    its major (first) axis, so that gathering the others leaves the
    `axis` block."""
    axes = entry_axes(entry)
    if axis in axes and axes[0] != axis:
        raise ValueError(f"placement {entry} puts {axis!r} after another "
                         f"axis; the cut needs it first")
    return (axis,) if axis in axes else (), tuple(a for a in axes
                                                   if a != axis)


class ServePlan:
    """The placement of a serving cell (prefill or decode) on a mesh with
    a "model" axis: every parameter leaf's spec under ``rules_for(cell.
    kind)`` and this rank's block (what a rank holds at rest), and what
    the cell's step gathers at its top to compute under the cut
    (:class:`~repro_torch.sharding.tp.ServeCut`): the mesh axes other
    than "model" of each placed dim. A dim placed over ``("model",
    "data")`` is numbered row-major in that order (``elastic.
    block_index``), so gathering it over "data" leaves the rank's "model"
    block; a dim placed over "data" alone (``"embed"``, ``"head_dim"``
    under ``SERVE_RULES``) is gathered whole. Under ``DEFAULT_RULES`` (the
    prefill) on a mesh whose DP axes are one rank, and under either rules
    at (1, 4), nothing is gathered. Caches: the rings (``"kv_seq"``)
    are used as they rest, sharded flash-decode over their slot block;
    the other cache leaves are gathered like parameters and cut back
    after the step. Building a plan creates the process groups it uses,
    so every rank builds it, in the same order."""

    def __init__(self, cell: Cell, mesh, axis: str = "model"):
        if cell.kind not in ("prefill", "decode"):
            raise ValueError(f"a serve plan takes a prefill or decode cell, "
                             f"not {cell.kind!r}")
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
        self.cell, self.mesh, self.axis = cell, mesh, axis
        self.model = cell.model
        self.ctx = cell.context(mesh)
        self.spec_tree = self.model.param_specs()
        specs = leaf_paths(self.spec_tree)
        self.paths, self.specs = list(specs), list(specs.values())
        self.shardings = [_sharding(s.shape, s.axes, self.ctx, mesh)
                          for s in self.specs]
        serve_groups(mesh)
        self.in_sh = cell.in_shardings(mesh)
        if cell.kind == "prefill":
            self.batch = cell.arg_specs[1]["tokens"].shape[0]
        else:
            self.batch = cell.arg_specs[2].shape[0]
            self.cache_axes = cell.arg_axes[1]
            self.max_len = cell.shape.seq_len
        self.cut = ServeCut.for_cell(self.model.cfg, mesh, self.ctx,
                                     self.batch, axis)

    # ------------------------------------------------------------ params
    def init_params(self, seed: int = 0, params: Optional[PyTree] = None,
                    device="cuda") -> ParamTree:
        """This rank's blocks of every parameter. Each leaf is drawn from
        its path's seed (``models.layers.init_leaf``), or taken from
        `params` (a whole tree), and cut before the next: the whole tree
        never exists on a rank, one whole leaf at a time. A block that is
        the whole leaf is the leaf itself (no copy)."""
        given = None if params is None else tree_leaves(params)
        blocks = {}
        for i, (path, spec) in enumerate(zip(self.paths, self.specs)):
            full = (init_leaf(seed, path, spec, device) if given is None
                    else given[i].detach().to(device, spec.dtype))
            blocks[path] = _block(full, self.shardings[i])
            del full
        return ParamTree(rebuild(self.spec_tree, blocks))

    def params_from(self, blocks: PyTree, other: "ServePlan") -> ParamTree:
        """This rank's blocks under this plan from its blocks under
        `other` (the other cell's plan of the same model on the same
        mesh): each leaf whose blocks coincide is kept, any other is
        gathered whole and cut again (:func:`relayout`; a collective)."""
        leaves = relayout(tree_leaves(blocks), other.shardings,
                          self.shardings, self.mesh)
        return ParamTree(rebuild(self.spec_tree,
                                 dict(zip(self.paths, leaves))))

    def compute(self, blocks: PyTree) -> PyTree:
        """The tree the cut computes with: each block with its dims'
        axes other than "model" gathered."""
        leaves = [_gather_other(b, sh, a, self.mesh, self.axis)
                  for b, sh, a in zip(tree_leaves(blocks), self.shardings,
                                      (s.axes for s in self.specs))]
        return rebuild(self.spec_tree, dict(zip(self.paths, leaves)))

    def bytes_at_rest(self) -> int:
        """The bytes of this rank's parameter blocks."""
        return sum(_numel(sh) * s.dtype.itemsize
                   for sh, s in zip(self.shardings, self.specs))

    # ------------------------------------------------------------ caches
    def cache_specs(self, max_len: int) -> PyTree:
        return self.model.cache_specs(self.batch, max_len)

    def cache_shardings(self, max_len: int) -> PyTree:
        """The rank's block of every cache leaf of ``w``-slot rings under
        this cell's rules."""
        specs = self.cache_specs(max_len)
        return shardings_for(specs, axes_from_specs(specs), self.mesh,
                             self.ctx)

    def empty_caches(self, max_len: int, device) -> PyTree:
        """This rank's blocks of zero-initialised caches (the reference's
        ``init_caches``)."""
        specs = self.cache_specs(max_len)
        return _map2(lambda s, sh: torch.zeros(_shape(sh), dtype=s.dtype,
                                               device=device),
                     specs, self.cache_shardings(max_len))

    def cache_view(self, caches: PyTree):
        """(the caches the decode cut computes with, a function that cuts
        the gathered leaves back into `caches`)."""
        pairs = []

        def view(block, sh_ax):
            sh, ax = sh_ax
            full = _gather_other(block, sh, ax, self.mesh, self.axis)
            if full is not block:
                pairs.append((block, full, sh, ax))
            return full

        shs = _map2(lambda sh, ax: (sh, ax), self.in_sh[1], self.cache_axes)
        tree = _map2(view, caches, shs)

        def back():
            for block, full, sh, ax in pairs:
                block.copy_(_own_part(full, sh, ax, self.mesh, self.axis))
        return tree, back

    # ------------------------------------------------------------ inputs
    def inputs(self, batch: Dict) -> Dict:
        """The cut's view of this rank's prefill input blocks: dims the
        rules place on "model" (the tokens' sequence under
        ``DEFAULT_RULES``) gathered; the batch rows stay this
        replica's."""
        out = {}
        for k, x in batch.items():
            sh = self.in_sh[1][k]
            if tuple(x.shape) != _shape(sh):
                raise ValueError(f"input {k!r}: block {tuple(x.shape)}, the "
                                 f"cell places {_shape(sh)}")
            for d, entry in enumerate(sh.spec):
                part, _ = _model_part(entry, self.axis)
                if part:
                    x = all_gather(x, d, self.mesh, part)
            out[k] = x
        return out

    def logits_block(self, logits: torch.Tensor, axes) -> torch.Tensor:
        """The rank's block of the (b, 1, V) logits under the rules, from
        the cut's (b, 1, V or V/tp): narrowed along the vocabulary."""
        cfg = self.model.cfg
        shape = (self.batch, 1, cfg.vocab_size)
        sh = _sharding(shape, axes, self.ctx, self.mesh)
        have = sh.index[2]
        lo = self.cut.index * logits.shape[2] if self.cut.vocab else 0
        return logits[:, :, have.start - lo:have.stop - lo]


def _sharding(shape, axes, ctx, mesh) -> Sharding:
    spec = resolve_pspec(shape, axes, ctx)
    return Sharding(tuple(shape), spec, block_index(shape, spec, mesh))


def _numel(sh: Sharding) -> int:
    return math.prod(_shape(sh))


def _shape(sh: Sharding) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in sh.index)


def _block(full: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's block of a whole leaf: a copy, or the leaf itself where
    the block is all of it."""
    if _shape(sh) == tuple(full.shape):
        return full
    return cut(full, sh)


def _gather_other(block: torch.Tensor, sh: Sharding, axes, mesh,
                  axis: str) -> torch.Tensor:
    """`block` with the axes other than `axis` of each placed dim
    gathered (batch rows and ring slots stay as they rest)."""
    x = block
    for d, entry in enumerate(sh.spec):
        if axes[d] in ("batch", "kv_seq"):
            continue
        _, other = _model_part(entry, axis)
        group = mesh.axes_group(other) if other else None
        if group is not None:
            x = gather_dim(x, d, group, block_order(mesh, other))
    return x


def _own_part(full: torch.Tensor, sh: Sharding, axes, mesh, axis: str
              ) -> torch.Tensor:
    """The inverse of :func:`_gather_other`: this rank's block of a
    tensor gathered over the other axes."""
    x = full
    for d, entry in enumerate(sh.spec):
        if axes[d] in ("batch", "kv_seq"):
            continue
        _, other = _model_part(entry, axis)
        if other:
            n = math.prod(mesh.shape[a] for a in other)
            k = 0
            for a in other:
                k = k * mesh.shape[a] + mesh.coords[mesh.axis_index(a)]
            x = take_rows(x, d, n, k)
    return x


def cell_step(cell: Cell, mesh, plan: Optional[ServePlan] = None
              ) -> Callable:
    """The serving cell on `mesh`, the counterpart of calling the jitted
    cell: every rank calls it with its blocks of each argument (under
    ``cell.in_shardings(mesh)``) and gets its blocks of the outputs under
    the same rules, no rank ever holding a whole parameter or cache leaf
    it does not own. Every collective is the step's own (``sharding/
    tp.py``); no gradient is kept.

    prefill: ``step(params, batch, max_len=None) -> (logits, caches)``,
    the caches' rings sized for ``max(prompt, max_len)`` slots
    (:meth:`ServePlan.cache_shardings` of that size places them).
    decode: ``step(params, caches, token, pos) -> (logits, caches)`` at a
    scalar `pos`, the caches updated in place. The logits are the
    rank's block of ``("batch", "seq", "vocab")``. ``step.plan`` is the
    plan."""
    plan = plan or ServePlan(cell, mesh)
    model = cell.model
    logit_axes = ("batch", "seq", "vocab")

    if cell.kind == "prefill":
        def step(params, batch, max_len: Optional[int] = None):
            with torch.no_grad():
                batch = plan.inputs(batch)
                s = batch["tokens"].shape[1] + (
                    model.cfg.num_vision_patches
                    if model.cfg.family == "vlm" else 0)
                plan.cut.max_len = max(s, max_len or 0)
                caches = plan.empty_caches(plan.cut.max_len,
                                           batch["tokens"].device)
                logits, caches = model.prefill_cut(plan.compute(params),
                                                   batch, caches, plan.cut)
                return plan.logits_block(logits, logit_axes), caches
    else:
        def step(params, caches, token, pos):
            with torch.no_grad():
                plan.cut.max_len = plan.max_len
                view, back = plan.cache_view(caches)
                logits, _ = model.decode_step_cut(plan.compute(params),
                                                  token, view, pos, plan.cut)
                back()
                return plan.logits_block(logits, logit_axes), caches
    step.plan = plan
    return step


def relayout(tree: PyTree, src: PyTree, dst: PyTree, mesh) -> PyTree:
    """This rank's blocks under the `dst` shardings from its blocks under
    `src` (the same leaves; :class:`~repro_torch.checkpoint.elastic.
    Sharding` trees): a leaf whose block is the same on both is kept as
    it is, any other is gathered whole and cut again, leaf by leaf in
    tree order (a collective: every rank calls it). Between the prefill
    and the decode cells on a mesh whose "data" axis has more than one
    rank, the caches' batch and slots move."""
    def one(x, pair):
        a, b = pair
        if a.index == b.index:
            return x
        return cut(unshard_leaf(x, a, mesh), b)

    return _map2(one, tree, _map2(lambda a, b: (a, b), src, dst))
