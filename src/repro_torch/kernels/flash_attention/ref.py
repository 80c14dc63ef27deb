"""Plain PyTorch version of blocked causal/sliding-window GQA attention.

The semantics are those of the Pallas kernel
(``repro.kernels.flash_attention.flash_attention.flash_attention_pallas``):
positions are ``arange`` on both sides, query head ``h`` reads KV head
``h // (hq // hkv)``, scores are float32 with scale ``1/sqrt(d)``, masked
scores are -1e30 and masked probabilities exactly 0, and the output is
``sum(p v) / max(sum(p), 1e-30)`` cast to ``q.dtype``.

A row that sees no key (``causal=False`` with a window, or a window that
hides every key) therefore comes out as zeros, as the Pallas kernel gives
it. The JAX package's own oracle (``repro/kernels/flash_attention/ref.py``)
takes a softmax over all -1e30 scores there and returns the mean of v; the
port follows the kernel (``ROADMAP.md`` Queue 3).

The CPU path of :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` and the card's oracle for the CUDA kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def visible(sq: int, sk: int, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """(sq, sk) boolean mask: key j is visible from query i."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (b, sq, hq, d); k, v: (b, sk, hkv, d). Returns (b, sq, hq, d)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    m = visible(sq, sk, causal, window, q.device)
    s = torch.where(m, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bhgsd", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
