"""The data-parallel train step: the port of the non-FSDP part of
``repro/launch/steps.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. On a DP-only mesh the gradient sum over the DP axes
is the explicit schedule of ``core/overlap.py``: ``ParallelConfig.overlap``
picks the HDOT buckets issued during the backward (:class:`GradBuckets`) or
the monolithic two-phase baseline after it. Without a mesh (or on a mesh
whose DP replicas are one rank) the gradients are the plain accumulation.
The dry-run's ``Cell``/``build_cell`` and the ZeRO-3 step wait
(``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

from repro_torch.config.base import ParallelConfig
from repro_torch.core.overlap import (GradBuckets, accumulate_grads,
                                      grad_sync_two_phase, microbatch_split,
                                      pmean, value_and_grad)
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import LanguageModel
from repro_torch.models.transformer import _not_ported
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine

PyTree = Any


def check_ported(parallel: ParallelConfig, mesh=None) -> None:
    """Raise ``NotImplementedError`` for what the data-parallel step does
    not honour: ZeRO-3, the collective-matmul rings, chunked MoE
    all-to-alls (expert parallelism, which needs the TP axis), compressed
    gradients, and a mesh whose non-DP axes (the TP axis) have more than
    one rank."""
    if parallel.param_shard:
        raise _not_ported("param_shard (ZeRO-3/FSDP)")
    if parallel.collective_matmul:
        raise _not_ported("collective_matmul (the TP rings)")
    if parallel.moe_a2a_chunks > 1:
        raise _not_ported(
            "moe_a2a_chunks > 1 in training: expert parallelism inside the "
            "model (moe_apply_ep over a2a_scan) needs a 'model' axis, and "
            "training on one waits for tensor parallelism of the other "
            "layers")
    if parallel.grad_compression != "none":
        raise _not_ported(f"grad_compression={parallel.grad_compression!r}")
    if mesh is not None:
        big = {a: s for a, s in mesh.shape.items()
               if a not in parallel.dp_axes and s > 1}
        if big:
            raise _not_ported(f"a mesh with non-DP axes of size > 1 {big} "
                           f"(tensor parallelism over {parallel.tp_axis!r})")


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
    those same tensors."""
    check_ported(parallel, mesh)
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
