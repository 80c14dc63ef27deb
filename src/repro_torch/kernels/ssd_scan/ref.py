"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan.

Math (per head h, state size N, head dim P)::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T        (state: P x N)
    y_t = h_t C_t

Chunked evaluation [arXiv:2405.21060 listing 1], as in the JAX package's
``repro/kernels/ssd_scan/ref.py``: within each chunk the masked C B^T
"attention" with the decay matrix L (:func:`ssd_chunk_terms`, the part the
CUDA kernel computes), across chunks a short recurrence over per-chunk
states and the off-diagonal term (:func:`ssd_combine`). Everything is
float32 whatever the inputs (the JAX oracle's choice, and the Pallas
kernel's); ``y`` comes back in ``x.dtype``, the final state in float32.

:func:`ssd_sequential` is the O(seq) recurrence (tests only) and
:func:`ssd_decode_step_ref` the one-token step of decoding; :func:`ssd_chunk_terms_vjp_ref` is the
plain backward of the within-chunk terms (the CUDA backward's oracle).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., q) -> (..., q, q) log-decay matrix: out[i, j] = sum of
    dA_k over j < k <= i for j <= i, -inf above the diagonal (so that exp
    never sees the positive upper-triangle differences)."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunk_terms(xc, dtc, A, Bc, Cc):
    """Per-chunk quantities in float32. Shapes (b=batch, c=chunks, q=chunk,
    h=heads, p=head dim, n=state): xc (b,c,q,h,p), dtc (b,c,q,h), A (h,),
    Bc, Cc (b,c,q,n). Returns y_diag (b,c,q,h,p), states (b,c,h,p,n),
    decay_chunk (b,c,h) and decay_in (b,c,q,h)."""
    xc, dtc, A = xc.float(), dtc.float(), A.float()
    Bc, Cc = Bc.float(), Cc.float()
    dA = dtc * A                                             # (b,c,q,h)
    L = torch.exp(segsum(dA.transpose(-1, -2)))              # (b,c,h,q,q)
    att = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)            # (b,c,q,k)
    xdt = xc * dtc[..., None]                                # (b,c,k,h,p)
    y_diag = torch.matmul(att[:, :, None] * L,               # (b,c,h,q,p)
                          xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    cs = torch.cumsum(dA, dim=2)                             # (b,c,q,h)
    total = cs[:, :, -1:, :]
    decay_states = torch.exp(total - cs)                     # (b,c,q,h)
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xdt * decay_states[..., None])
    return y_diag, states, torch.exp(total[:, :, 0, :]), torch.exp(cs)


def ssd_chunk_terms_vjp_ref(xc, dtc, A, Bc, Cc, dy_diag, dstates,
                            ddecay_in):
    """The plain backward of the within-chunk terms: the gradients of
    :func:`ssd_chunk_terms` at (xc, dtc, A, Bc, Cc) for the cotangents of
    y_diag (b,c,q,h,p), states (b,c,h,p,n) and decay_in (b,c,q,h) (the
    kernel path takes decay_chunk from decay_in[:, :, -1], so its
    cotangent arrives there). Returns (dx, ddt, dA, dB, dC) in the
    inputs' shapes and dtypes."""
    leaves = [t.detach().requires_grad_(True)
              for t in (xc, dtc, A, Bc, Cc)]
    with torch.enable_grad():
        y_diag, states, _, decay_in = ssd_chunk_terms(*leaves)
        return torch.autograd.grad((y_diag, states, decay_in), leaves,
                                   (dy_diag, dstates, ddecay_in))


def ssd_combine(y_diag, states, decay_chunk, decay_in, Cc,
                initial_state: Optional[torch.Tensor] = None,
                out_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-chunk recurrence and the off-diagonal term, in float32:
    each chunk starts from the state the chunks before it leave, decayed
    into its rows. states (b,c,h,p,n). Returns (y (b, c*q, h, p) in
    out_dtype, final state (b,h,p,n) f32)."""
    b, c, q, h, p = y_diag.shape
    n = states.shape[-1]
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=y_diag.device)
             if initial_state is None else initial_state.float())
    prevs = []
    for i in range(c):
        prevs.append(carry)
        carry = carry * decay_chunk[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prevs, dim=1)                  # (b,c,h,p,n)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc.float(), prev_states)
    y = y_diag + y_off * decay_in[..., None]
    return y.reshape(b, c * q, h, p).to(out_dtype), carry


def _chunks(x, dt, B, C, chunk: int):
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk != 0:
        raise ValueError(f"ssd: length {l} is not a multiple of the chunk "
                         f"{chunk} (ops.ssd pads it)")
    c = l // chunk
    return (x.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h),
            B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n))


def ssd_ref(x, dt, A, B, C, chunk: int,
            initial_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p), dt (b,l,h) [post-softplus], A (h,) [negative], B, C
    (b,l,n); l a multiple of `chunk`. Returns (y (b,l,h,p) in x.dtype,
    final state (b,h,p,n) f32)."""
    xc, dtc, Bc, Cc = _chunks(x, dt, B, C, chunk)
    y_diag, states, decay_chunk, decay_in = ssd_chunk_terms(xc, dtc, A, Bc,
                                                            Cc)
    return ssd_combine(y_diag, states, decay_chunk, decay_in, Cc,
                       initial_state, x.dtype)


def ssd_sequential(x, dt, A, B, C, initial_state=None):
    """The O(l) recurrence, float32 (tests only)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    ys = []
    for t in range(l):
        y, st = ssd_decode_step_ref(st, x[:, t].float(), dt[:, t], A,
                                    B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), st


def ssd_decode_step_ref(state, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence. state (b,h,p,n); x_t (b,h,p); dt_t (b,h);
    B_t, C_t (b,n). Returns (y (b,h,p) in x_t.dtype, new state f32)."""
    dt_t = dt_t.float()
    dA = torch.exp(dt_t * A.float())                         # (b,h)
    inp = torch.einsum("bh,bhp,bn->bhpn", dt_t, x_t.float(), B_t.float())
    new = state.float() * dA[..., None, None] + inp
    y = torch.einsum("bhpn,bn->bhp", new, C_t.float())
    return y.to(x_t.dtype), new
