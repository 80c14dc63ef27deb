"""The control's weight products in fp8, the step below the bfloat16 the
configurations state: both operands of the forward product rounded to
float8 e4m3 and the incoming gradient to float8 e5m2, each with one
scale per tensor (its largest magnitude mapped to the format's largest
value), then multiplied and summed in float32 - what fp8 training does.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        qa = _round(a, torch.float8_e4m3fn, E4M3_MAX)
        qw = _round(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2, E5M2_MAX)
        da = qg @ qw.t()
        dw = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return da, dw


def fp8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., k) @ w (k, n) with fp8 operands, float32 out."""
    return _Fp8Matmul.apply(a, w)
