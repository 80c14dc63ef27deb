"""Plain PyTorch versions of the gated linear recurrence
``h_t = a_t * h_{t-1} + b_t`` over (batch, seq, width) (the RG-LRU inner
loop, Griffin [arXiv:2402.19427]).

:func:`lru_scan_ref` composes the steps associatively,
``(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)``, in log2(seq) vectorised
rounds (Hillis-Steele), as the JAX package's oracle does with
``lax.associative_scan`` (torch has no associative scan). The carry is
float32 whatever the inputs; an initial state ``h0`` is folded into the
first step in float32, as the Pallas kernel carries it
(``repro/kernels/lru_scan/lru_scan.py``). Returns ``h`` in ``b.dtype`` and
``h_last`` in float32.

:func:`lru_scan_sequential` is the O(seq) loop, the ground truth of the
tests. :func:`lru_scan_vjp_ref` is the plain backward, autograd of
:func:`lru_scan_ref`. This module is the CPU path of
:func:`repro_torch.kernels.lru_scan.ops.lru_scan` and the card's oracle for
the CUDA kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (batch, seq, width); h0: (batch, width) or None. Returns
    (h (batch, seq, width) in b.dtype, h_last (batch, width) f32)."""
    af = a.float()
    bf = b.float()
    if h0 is not None:
        bf = bf.clone()
        bf[:, 0] += af[:, 0] * h0.float()
    l = a.shape[1]
    off = 1
    while off < l:
        bf = torch.cat([bf[:, :off], af[:, off:] * bf[:, :-off] + bf[:, off:]],
                       dim=1)
        af = torch.cat([af[:, :off], af[:, off:] * af[:, :-off]], dim=1)
        off *= 2
    return bf.to(b.dtype), bf[:, -1]


def lru_scan_vjp_ref(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor], dh: torch.Tensor,
                     dh_last: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """The plain backward: the gradients of :func:`lru_scan_ref` at (a, b,
    h0) for the cotangents dh of h and dh_last of h_last (None: zero).
    Returns (da, db, dh0), dh0 None without h0."""
    leaves = [t.detach().requires_grad_(True) for t in (a, b)]
    if h0 is not None:
        leaves.append(h0.detach().requires_grad_(True))
    with torch.enable_grad():
        h, h_last = lru_scan_ref(leaves[0], leaves[1],
                                 leaves[2] if h0 is not None else None)
        outs, cots = [h], [dh]
        if dh_last is not None:
            outs.append(h_last)
            cots.append(dh_last)
        grads = torch.autograd.grad(outs, leaves, cots)
    return grads[0], grads[1], grads[2] if h0 is not None else None


def lru_scan_sequential(a: torch.Tensor, b: torch.Tensor,
                        h0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(seq) loop, float32 carry (tests only)."""
    bsz, l, w = a.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = []
    for t in range(l):
        h = a[:, t].float() * h + b[:, t].float()
        out.append(h)
    return torch.stack(out, 1).to(b.dtype), h
