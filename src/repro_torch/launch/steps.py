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
(:func:`make_tp_train_step`, every family but moe): the parameters and AdamW
moments at rest are this rank's blocks under ``rules_for("train")``
(:class:`TPPlan`), the forward and backward run the Megatron cut with
sequence parallelism (:mod:`repro_torch.sharding.tp`), and where the JAX
package leaves every collective to GSPMD, the step issues them itself.

``make_fsdp_train_step`` is the ZeRO-3 composition
(``ParallelConfig.param_shard``): params and AdamW moments live as
bucket-wise flat buffers sharded over the DP ranks (:func:`fsdp_init_state`,
one bucket at a time), gathered all at the top of the step and
reduce-scattered last-backward-first, or, with ``fsdp_streaming``, gathered
layer by layer inside each layer's remat region (``FsdpStream``). The
dry-run's ``Cell``/``build_cell`` waits (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ParallelConfig
from repro_torch.core.overlap import (FsdpLayout, GradBuckets, _pack_group,
                                      accumulate_grads, fsdp_all_gather,
                                      fsdp_group, fsdp_layout, fsdp_stream,
                                      grad_sync_fsdp, grad_sync_two_phase,
                                      microbatch_split, pmean, shard_slice,
                                      value_and_grad)
from repro_torch.checkpoint.elastic import Sharding, block_index, cut
from repro_torch.models.layers import (ParamTree, init_leaf, leaf_paths,
                                      rebuild, tree_leaves, tree_map)
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import _not_ported
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.sharding.rules import (ShardingContext, entry_axes,
                                        resolve_pspec, rules_for)
from repro_torch.sharding.tp import (TPCut, all_gather, global_norm_by_class,
                                     grad_all_reduce)

PyTree = Any


def tp_size(parallel: ParallelConfig, mesh) -> int:
    """The rank count of the mesh's TP axis (1 without a mesh or axis)."""
    if mesh is None:
        return 1
    return mesh.shape.get(parallel.tp_axis, 1)


def check_ported(parallel: ParallelConfig, mesh=None,
                 family: Optional[str] = None) -> None:
    """Raise for what the train steps do not honour. ZeRO-3 needs an
    explicit DP-only mesh (``ValueError``, as in the JAX package: it never
    quietly replicates, so ``param_shard`` with a TP axis raises too);
    ``NotImplementedError`` for chunked MoE all-to-alls (expert parallelism
    inside a trained model), a TP axis of more than one rank under
    ``family="moe"`` (both ``ROADMAP.md`` Queue 1 item 10), and any other
    non-DP axis of more than one rank. ``collective_matmul`` and
    ``grad_compression`` are read nowhere, as in the JAX package, whose
    trainer trains the same step with either set (the TP rings serve
    decode: ``models/decode_tp.py``; the int8 codec serves
    ``core/reduction.py``'s staged all-reduce)."""
    if parallel.param_shard:
        _require_explicit_mesh(parallel, mesh)
    if parallel.moe_a2a_chunks > 1:
        raise _not_ported(
            "moe_a2a_chunks > 1 in training: expert parallelism inside the "
            "model (moe_apply_ep over a2a_scan, its all-to-alls under "
            "autograd; ROADMAP.md, Queue 1 item 10)")
    if mesh is not None:
        big = {a: s for a, s in mesh.shape.items()
               if a not in parallel.dp_axes and s > 1}
        other = {a: s for a, s in big.items() if a != parallel.tp_axis}
        if other:
            raise _not_ported(f"a mesh with non-DP, non-TP axes of size > 1 "
                              f"{other}")
        if big and family == "moe":
            raise _not_ported(
                f"tensor-parallel training of the 'moe' family over "
                f"{parallel.tp_axis!r} {big} (ROADMAP.md, Queue 1 item 10: "
                f"expert parallelism in training; every other family "
                f"trains on a TP mesh)")


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
    check_ported(parallel, mesh, model.cfg.family)
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
            loss = model.train_loss(params, mb)
            loss.backward()
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
    TP axis places "heads", "kv_heads", "mlp" and "vocab". At the top of a
    step :meth:`gather_data` all-gathers the data-placed dims (its backward
    reduce-scatters the gradient over the DP replicas) and marks the DP
    axes a leaf is replicated on (its gradient all-reduced there): every
    leaf becomes its TP block. Per microbatch :meth:`model_view` gathers
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

    def gather_data(self, i: int, w: torch.Tensor) -> torch.Tensor:
        data, rest = self._data[i]
        for d, ax in data:
            w = all_gather(w, d, self.mesh, ax)
        return grad_all_reduce(w, self.mesh, rest) if rest else w

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

    The step gathers the data-placed dims at its top
    (:meth:`TPPlan.gather_data`), runs the forward and backward of each of
    ``accum_steps`` microbatches under the cut (``train_loss(..., tp)``,
    each rank's loss over its own rows divided by the TP rank count, so a
    model line's losses sum to its mean) and accumulates the gradients of
    the TP blocks, then takes them back through the data gathers once:
    each rank holds the gradient of its own block, summed over every rank
    that touched it, divided by the DP replica count as the DP step does.
    The grad norm counts unique elements only (one all-reduce of square
    sums per placement class, over the axes that shard it); AdamW runs on
    the blocks. The loss is the mean over every token (one all-reduce).
    ``parallel.overlap`` is read nowhere here, as in the JAX package,
    where the partitioner schedules the reductions."""
    check_ported(parallel, mesh, model.cfg.family)
    opt_cfg = opt_cfg or AdamWConfig()
    plan = plan or TPPlan(model, parallel, mesh)
    inv_tp = 1.0 / plan.tp

    def loss_and_grad(blocks, batch):
        view = {p: plan.model_view(i, b)
                for i, (p, b) in enumerate(zip(plan.paths, blocks))}
        loss = model.train_loss(rebuild(plan.spec_tree, view), batch,
                                tp=plan.cut)
        return loss.detach(), list(torch.autograd.grad(loss * inv_tp, blocks))

    def step_fn(params, opt_state, batch):
        leaves = tree_leaves(params)
        full = [plan.gather_data(i, w) for i, w in enumerate(leaves)]
        loss, acc = accumulate_grads(
            loss_and_grad, [f.detach().requires_grad_() for f in full],
            batch, parallel.accum_steps)
        grads = []
        for f, w, a in zip(full, leaves, acc):
            if f is not w:      # back through the data gather / all-reduce
                a = torch.autograd.grad(f, w, a.to(f.dtype))[0]
            grads.append(a.div_(plan.dp) if plan.dp > 1 else a)
        del full, acc
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
