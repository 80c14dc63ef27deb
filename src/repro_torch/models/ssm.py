"""Mamba-2 block (SSD, state-space duality) [arXiv:2405.21060]. The port of
``repro/models/ssm.py``.

Separate z/x/B/C/dt projections, as in the JAX package (its parameter
tree is loaded unchanged). The SSD scan of a full sequence runs through
:mod:`repro_torch.kernels.ssd_scan` (the CUDA kernel for the within-chunk
terms on the card, the plain version on the CPU); the one-token decode
step stays plain PyTorch, as in the JAX package. :func:`ssm_train_tp` is
the block under the tensor-parallel cut (the rank's ``d_inner`` columns
and SSD heads), which GSPMD derives in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import (ParamSpec, conv_tail, rms_norm,
                                      rms_norm_split)
from repro_torch.runtime.tracing import region


def ssm_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.num_heads(d)
    n = s.state_dim
    k = s.conv_kernel
    return {
        "wz": ParamSpec((d, di), ("embed", "mlp"), dtype),
        "wx": ParamSpec((d, di), ("embed", "mlp"), dtype),
        "wB": ParamSpec((d, n), ("embed", "state"), dtype),
        "wC": ParamSpec((d, n), ("embed", "state"), dtype),
        "wdt": ParamSpec((d, h), ("embed", "heads"), dtype),
        "dt_bias": ParamSpec((h,), ("heads",), torch.float32, "zeros"),
        "A_log": ParamSpec((h,), ("heads",), torch.float32, "zeros"),
        "D": ParamSpec((h,), ("heads",), torch.float32, "ones"),
        "conv_x": ParamSpec((k, di), ("conv", "mlp"), dtype),
        "conv_B": ParamSpec((k, n), ("conv", "state"), dtype),
        "conv_C": ParamSpec((k, n), ("conv", "state"), dtype),
        "norm": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "wo": ParamSpec((di, d), ("mlp", "embed"), dtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """x: (b, l, c); w: (k, c). Causal depthwise conv then silu; `state` is
    the last k-1 inputs before x (zeros if None)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + x.shape[1]] * w[j]
    return F.silu(out)


def _convs(p, x, B, C):
    return (_causal_depthwise_conv(x, p["conv_x"]),
            _causal_depthwise_conv(B, p["conv_B"]),
            _causal_depthwise_conv(C, p["conv_C"]))


def _project(p, u: torch.Tensor, cfg: ModelConfig):
    z = u @ p["wz"]
    x = u @ p["wx"]
    B = u @ p["wB"]
    C = u @ p["wC"]
    # dt's f32 projection is summed in f64 and rounded once, which gives
    # the correctly rounded f32 result whatever order the GEMM sums in: on
    # CUDA a 1-row f32 product takes another path than an 8-row one, and a
    # request's decode must not depend on how many slots run beside it
    dt = F.softplus((u.double() @ p["wdt"].double()).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, x, B, C, dt, A


def _gate_norm(p, y, xh, z, cfg: ModelConfig):
    """D skip, gate by silu(z), norm (:func:`_gated_norm` on one rank)."""
    b, l = z.shape[:2]
    y = y + xh * p["D"][:, None].to(xh.dtype)
    y = y.reshape(b, l, -1)
    return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)


def _out(p, y, xh, z, cfg: ModelConfig):
    """D skip, gate by silu(z), norm, out projection."""
    return _gate_norm(p, y, xh, z, cfg) @ p["wo"]


def ssm_prefill(p, u: torch.Tensor, cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba-2 block and the state decode continues from:
    the final SSD state (b, h, p, n) f32 and the conv inputs (b, k-1, .).
    Its parts are the spans ``ssm.proj`` (the five input projections and
    ``wo``'s), ``ssm.conv``, ``ssm.scan`` and ``ssm.gate_norm``
    (``runtime/tracing.py``)."""
    s = cfg.ssm
    b, l, d = u.shape
    z, x, B, C, dt, A = region("ssm.proj", _project, p, u, cfg)
    xc, Bc, Cc = region("ssm.conv", _convs, p, x, B, C)
    xh = xc.reshape(b, l, s.num_heads(d), s.head_dim)
    y, final = region("ssm.scan", ssd_ops.ssd, xh, dt, A, Bc, Cc,
                      min(s.chunk_size, l), impl=impl)
    k = s.conv_kernel
    cache = {"state": final, "conv_x": conv_tail(x, k),
             "conv_B": conv_tail(B, k), "conv_C": conv_tail(C, k)}
    y = region("ssm.gate_norm", _gate_norm, p, y, xh, z, cfg)
    return region("ssm.proj", torch.matmul, y, p["wo"]), cache


def ssm_train_tp(p, u_rows: torch.Tensor, cfg: ModelConfig, tp
                 ) -> torch.Tensor:
    """The full-sequence block under the tensor-parallel cut (``tp``, a
    :class:`~repro_torch.sharding.tp.TPCut`; JAX ``ssm.py:75-95`` under
    GSPMD): `u_rows` are this rank's (b, l/tp, d) rows and `p` its blocks.
    The rows are all-gathered; ``wz``, ``wx`` and ``conv_x`` give the
    rank's ``d_inner`` columns, ``wdt`` its heads, the replicated ``wB``
    and ``wC`` the whole B and C; the SSD scan (:func:`~repro_torch.
    kernels.ssd_scan.ops.ssd`, kernels forward and backward on the card)
    runs on the rank's heads; the gated norm over the whole ``d_inner``
    sums its square sums over the ranks; ``wo``'s rows leave through a
    reduce-scatter. Where the rules place ``d_inner`` but replicate the
    heads, the rank's columns are not whole heads: it gathers the conv's
    output over the columns, scans every head and takes its columns of
    the result. Where they replicate both, the rank computes the whole
    block and takes its rows."""
    return _ssm_cut(p, u_rows, cfg, tp)[0]


def ssm_prefill_tp(p, u_rows: torch.Tensor, cfg: ModelConfig, tp
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`ssm_prefill` under the serving cut: :func:`ssm_train_tp`'s
    block, and the state decode continues from on the rank's block of
    it: the final SSD state of the rank's heads (of every head where the
    rules place ``d_inner`` but not the heads), the conv inputs of its
    ``d_inner`` columns and the whole B and C."""
    y, final, x, B, C = _ssm_cut(p, u_rows, cfg, tp)
    k = cfg.ssm.conv_kernel
    return y, {"state": final, "conv_x": conv_tail(x, k),
               "conv_B": conv_tail(B, k), "conv_C": conv_tail(C, k)}


def _ssm_cut(p, u_rows, cfg: ModelConfig, tp):
    """(the rows of the block's output, the final SSD state, the
    projections x, B and C before their convs) under the cut, in the
    spans of :func:`ssm_prefill` (the collectives outside them)."""
    s = cfg.ssm
    u = tp.gather_seq(u_rows)
    b, l, d = u.shape
    z, x, B, C, dt, A = region("ssm.proj", _project, p, u, cfg)
    xc, Bc, Cc = region("ssm.conv", _convs, p, x, B, C)
    split = tp.inner and not tp.ssm_heads
    if split:
        xc = tp.gather_cols(xc)
    xh = xc.reshape(b, l, -1, s.head_dim)
    y, final = region("ssm.scan", ssd_ops.ssd, xh, dt, A, Bc, Cc,
                      min(s.chunk_size, l))
    y = region("ssm.gate_norm", _gated_norm, p, y, xh, z, cfg, tp, split)
    y = region("ssm.proj", torch.matmul, y, p["wo"])
    return tp.leave(y, tp.inner), final, x, B, C


def _gated_norm(p, y, xh, z, cfg: ModelConfig, tp, split: bool):
    """The D skip, the gate by silu(z) and the norm over the whole
    ``d_inner`` on the rank's columns (gathered heads cut back to them
    where `split`)."""
    b, l = z.shape[:2]
    y = (y + xh * p["D"][:, None].to(xh.dtype)).reshape(b, l, -1)
    if split:
        y = tp.cols(y)
    y = y * F.silu(z)
    if tp.inner:
        return rms_norm_split(y, p["norm"], cfg.norm_eps,
                              cfg.ssm.d_inner(cfg.d_model), tp.all_reduce)
    return rms_norm(y, p["norm"], cfg.norm_eps)


def ssm_apply(p, u: torch.Tensor, cfg: ModelConfig,
              impl: str = "auto") -> torch.Tensor:
    """Full-sequence Mamba-2 block. u: (b, l, d)."""
    y, _ = ssm_prefill(p, u, cfg, impl)
    return y


# ----------------------------------------------------------------- decode path
def ssm_cache_specs(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    h = s.num_heads(cfg.d_model)
    k = s.conv_kernel
    return {
        "state": ParamSpec((batch, h, s.head_dim, s.state_dim),
                           ("batch", "act_heads", None, None),
                           torch.float32, "zeros"),
        "conv_x": ParamSpec((batch, k - 1, di), ("batch", None, "mlp"),
                            dtype, "zeros"),
        "conv_B": ParamSpec((batch, k - 1, s.state_dim),
                            ("batch", None, None), dtype, "zeros"),
        "conv_C": ParamSpec((batch, k - 1, s.state_dim),
                            ("batch", None, None), dtype, "zeros"),
    }


def ssm_decode_step(p, u: torch.Tensor, cfg: ModelConfig, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (b, 1, d). Returns (out (b, 1, d), the new state); the caller
    writes the state into its cache."""
    s = cfg.ssm
    b = u.shape[0]
    z, x, B, C, dt, A = _project(p, u, cfg)

    def conv_step(x1, w, st):
        y = _causal_depthwise_conv(x1, w, state=st)
        return y, torch.cat([st.to(x1.dtype), x1], dim=1)[:, 1:]

    x, cx = conv_step(x, p["conv_x"], cache["conv_x"])
    B, cB = conv_step(B, p["conv_B"], cache["conv_B"])
    C, cC = conv_step(C, p["conv_C"], cache["conv_C"])
    xh = x.reshape(b, 1, s.num_heads(cfg.d_model), s.head_dim)
    y, new_state = ssd_ops.ssd_decode_step(cache["state"], xh[:, 0],
                                           dt[:, 0], A, B[:, 0], C[:, 0])
    out = _out(p, y[:, None], xh, z, cfg)
    return out, {"state": new_state, "conv_x": cx, "conv_B": cB,
                 "conv_C": cC}


def ssm_decode_tp(p, u: torch.Tensor, cfg: ModelConfig, tp, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`ssm_decode_step` under the serving cut: `u` (b, 1, d) whole
    on every rank, `cache` the rank's block of the state (as
    :func:`ssm_prefill_tp` leaves it). The rank steps its heads over its
    ``d_inner`` columns (every head where the columns are not whole
    heads: the conv's output is gathered, as in training), norms over
    the whole width, and ``wo``'s partial sums are all-reduced."""
    s = cfg.ssm
    b = u.shape[0]
    z, x, B, C, dt, A = _project(p, u, cfg)

    def conv_step(x1, w, st):
        y = _causal_depthwise_conv(x1, w, state=st)
        return y, torch.cat([st.to(x1.dtype), x1], dim=1)[:, 1:]

    x, cx = conv_step(x, p["conv_x"], cache["conv_x"])
    B, cB = conv_step(B, p["conv_B"], cache["conv_B"])
    C, cC = conv_step(C, p["conv_C"], cache["conv_C"])
    split = tp.inner and not tp.ssm_heads
    if split:
        x = tp.gather_cols(x)
    xh = x.reshape(b, 1, -1, s.head_dim)
    y, new_state = ssd_ops.ssd_decode_step(cache["state"], xh[:, 0],
                                           dt[:, 0], A, B[:, 0], C[:, 0])
    y = _gated_norm(p, y[:, None], xh, z, cfg, tp, split) @ p["wo"]
    return (tp.all_reduce(y) if tp.inner else y,
            {"state": new_state, "conv_x": cx, "conv_B": cB, "conv_C": cC})
