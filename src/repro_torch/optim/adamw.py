"""AdamW on trees of tensors: the port of ``repro/optim/adamw.py``.

The moments have their parameters' shapes (float32 by default) and the
update runs in float32 and casts back, as in the JAX package. Parameters
and moments are updated in place (under ``torch.no_grad``); the function
still returns them, so its callers read like the JAX package's. Gradients
arrive already reduced (the train step's grad sync, ``core/overlap.py``).
Under ZeRO-3 each rank holds 1/n of the flat buffers, and the one
collective is the global gradient norm's: the local sum of squares is
all-reduced over the DP group (`group`) before the clip scale is formed,
so every rank clips by the same norm (under GSPMD the JAX package's norm
is over the whole tree by construction).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime.tracing import span

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: PyTree, moment_dtype=torch.float32) -> PyTree:
    """{"m", "v": zeros shaped like `params` (nested dicts and lists) in
    `moment_dtype`, "step": int32 0}, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: PyTree, group=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in tree
    order; with `group` (the DP ranks each holding a shard of every
    leaf), the local sum is all-reduced over it first."""
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    if group is not None:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads: PyTree, state: PyTree, params: PyTree,
                 cfg: AdamWConfig, lr: torch.Tensor, chunk_leading: int = 0,
                 group=None, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[PyTree, PyTree, torch.Tensor]:
    """Returns (params, state, grad_norm), params and moments updated in
    place; `lr` is the scheduled value. Gradients are clipped to
    ``cfg.grad_clip`` global norm; weight decay is decoupled.

    chunk_leading > 0: leaves whose leading dim equals it (the scanned layer
    stacks) are updated one slice at a time, which bounds the float32
    temporaries to one layer's worth. `group`: the DP group over which
    `grads` are sharded (ZeRO-3), for the global norm. `gnorm`: the
    global norm, already computed (the tensor-parallel step's, over unique
    elements of blocks placed in several ways). Its work is one span,
    "adamw_update" (``runtime/tracing.py``)."""
    with span("adamw_update"):
        return _update(grads, state, params, cfg, lr, chunk_leading, group,
                       gnorm)


def _update(grads, state, params, cfg, lr, chunk_leading, group, gnorm):
    if gnorm is None:
        gnorm = global_norm(grads, group)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    step = state["step"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        if chunk_leading and p.dim() >= 2 and p.shape[0] == chunk_leading:
            for i in range(chunk_leading):
                upd(g[i], m[i], v[i], p[i])
        else:
            upd(g, m, v, p)
    state["step"] = step
    return params, state, gnorm
