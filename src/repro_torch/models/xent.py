"""Fused linear + cross-entropy with its own backward: the port of
``repro/models/xent.py``.

The naive tail ``logits = x @ W; loss = -mean(log_softmax[targets])``
keeps the (b, s, V) float32 log-probabilities for the backward and
scatter-adds into them. :func:`linear_xent` instead

  forward:  float32 logits, the loss from the logsumexp and the gathered
            target logit; saves only (x, w, targets, lse);
  backward: recomputes the logits once and forms
            ``dlogits = (softmax - onehot) * g / N`` elementwise (an iota
            comparison, no scatter), cast to x's dtype; ``dx`` and ``dw``
            are products in that dtype.

The logits are the float32 sums of x's and w's products, never rounded to
bf16 first (the JAX package's ``preferred_element_type=float32``): on the
CPU by a float32 product of the widened operands (bf16 products are exact
in float32); on the card by cuBLAS's bf16-in/float32-out GEMM
(``torch.mm(..., out_dtype=torch.float32)``), the same products on the
tensor cores.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.tracing import span


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, d) @ (d, V) -> (b, s, V) float32."""
    b, s, d = x.shape
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x.reshape(b * s, d), w, out_dtype=torch.float32)
        return out.view(b, s, -1)
    return torch.einsum("bsd,dv->bsv", x.float(), w.float())


class _LinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, denom):
        with span("linear_xent"):
            logits = _logits(x, w)
            lse = torch.logsumexp(logits, dim=-1)                  # (b, s)
            ll = torch.gather(logits, -1, targets[..., None])[..., 0]
            ctx.save_for_backward(x, w, targets, lse)
            ctx.denom = denom
            if denom is None:
                return torch.mean(lse - ll)
            return torch.sum(lse - ll) / denom

    @staticmethod
    def backward(ctx, g):
        with span("linear_xent_backward"):
            return _backward(ctx, g)


def _backward(ctx, g):
    x, w, targets, lse = ctx.saved_tensors
    n = targets.numel() if ctx.denom is None else ctx.denom
    p = _logits(x, w).sub_(lse[..., None]).exp_()                  # recompute
    iota = torch.arange(p.shape[-1], device=p.device)
    # where(iota == t, p - 1, p), in place (the mask read as 0/1 bytes;
    # subtracting 0 leaves p exact)
    p.sub_((iota == targets[..., None]).view(torch.uint8))
    dlogits = p.mul_(g / n).to(x.dtype)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = torch.einsum("bsv,dv->bsd", dlogits, w)
    if ctx.needs_input_grad[1]:
        dw = torch.einsum("bsd,bsv->dv", x, dlogits).to(w.dtype)
    return dx, dw, None, None


def linear_xent(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                denom: Optional[float] = None) -> torch.Tensor:
    """x: (b, s, d) activations; w: (d, V); targets: (b, s) int64.
    Returns the mean cross-entropy over all positions (0-d float32), or,
    given `denom`, their sum divided by it (a rank's share of a mean over
    positions that other ranks hold too; s may then be 0)."""
    return _LinearXent.apply(x, w, targets, denom)


def xent_ref(x: torch.Tensor, w: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """Naive reference (the unfused train_loss tail), the test oracle."""
    logits = torch.einsum("bsd,dv->bsv", x, w).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -torch.mean(ll)
