"""Griffin/RecurrentGemma recurrent block: conv1d -> RG-LRU, gated
[arXiv:2402.19427]. The port of ``repro/models/rglru.py``.

    r_t = sigmoid(x_t Wr + br)            (recurrence gate)
    i_t = sigmoid(x_t Wi + bi)            (input gate)
    a_t = exp(-c * softplus(L) * r_t)     (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs through :mod:`repro_torch.kernels.lru_scan` (the
CUDA kernel on the card, its plain version on the CPU); the one-token
decode step stays plain PyTorch, as in the JAX package.
:func:`rglru_train_tp` is the block under the tensor-parallel cut (the
rank's block of the LRU width), which GSPMD derives in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models.layers import ParamSpec, conv_tail

_C = 8.0


def rglru_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    hb = cfg.hybrid
    d = cfg.d_model
    w = hb.lru_width or d
    k = hb.conv_kernel
    return {
        "w_gate": ParamSpec((d, w), ("embed", "lru"), dtype),
        "w_in": ParamSpec((d, w), ("embed", "lru"), dtype),
        "conv": ParamSpec((k, w), ("conv", "lru"), dtype),
        "wr": ParamSpec((w, w), ("lru", None), dtype),
        "br": ParamSpec((w,), (None,), torch.float32, "zeros"),
        "wi": ParamSpec((w, w), ("lru", None), dtype),
        "bi": ParamSpec((w,), (None,), torch.float32, "zeros"),
        "a_log": ParamSpec((w,), (None,), torch.float32, "zeros"),
        "w_out": ParamSpec((w, d), ("lru", "embed"), dtype),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input), both float32."""
    xf = x.float()
    return _gate_values(xf, xf @ p["wr"].float(), xf @ p["wi"].float(),
                        p["br"], p["bi"], p["a_log"])


def _gate_values(xf, r_pre, i_pre, br, bi, a_log
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input) from the gates' products before their biases."""
    r = torch.sigmoid(r_pre + br)
    i = torch.sigmoid(i_pre + bi)
    log_a = -_C * F.softplus(a_log) * r                       # (b,l,w)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def _conv1d(x: torch.Tensor, w: torch.Tensor,
            state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over the sequence: x (b, l, c), w (k, c);
    `state` is the last k-1 inputs before x (zeros if None)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + x.shape[1]] * w[j]
    return out


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig,
                impl: str = "auto") -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (b, l, d)."""
    y, _ = rglru_prefill(p, x, cfg, impl)
    return y


def rglru_prefill(p, x: torch.Tensor, cfg: ModelConfig, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence block and the state decode continues from: h (b, w)
    f32 and conv (b, k-1, w)."""
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    a, b = _gates(p, _conv1d(u, p["conv"]))
    h, h_last = lru_ops.lru_scan(a, b, impl=impl)
    y = gate.float() * h.float()
    out = y.to(x.dtype) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_tail(u, cfg.hybrid.conv_kernel)}


def rglru_train_tp(p, x_rows: torch.Tensor, cfg: ModelConfig, tp
                   ) -> torch.Tensor:
    """The full-sequence block under the tensor-parallel cut (``tp``, a
    :class:`~repro_torch.sharding.tp.TPCut`; JAX ``rglru.py:46-75`` under
    GSPMD): `x_rows` are this rank's (b, l/tp, d) rows and `p` its blocks.
    The rows are all-gathered; ``w_gate``, ``w_in`` and ``conv`` give the
    rank's block of the LRU width. ``wr`` and ``wi`` are placed on their
    input dim (``("lru", None)``), so the rank's product is a partial sum
    over the whole width: it is reduce-scattered along the width, each
    rank keeping its block of the gates' pre-activations (the backward
    all-gathers). The replicated biases and ``a_log`` are cut to the
    block, the scan (:func:`~repro_torch.kernels.lru_scan.ops.lru_scan`,
    kernels forward and backward on the card) runs on the rank's (b, l,
    w/tp) block, and ``w_out``'s rows leave through a reduce-scatter.
    Where the rules replicate the width, the rank computes the whole
    block and takes its rows."""
    return _rglru_cut(p, x_rows, cfg, tp)[0]


def rglru_prefill_tp(p, x_rows: torch.Tensor, cfg: ModelConfig, tp
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`rglru_prefill` under the serving cut: :func:`rglru_train_tp`'s
    block, and the state decode continues from on the rank's block of the
    width: its h (b, w/tp) f32 and conv inputs."""
    y, h_last, u = _rglru_cut(p, x_rows, cfg, tp)
    return y, {"h": h_last, "conv": conv_tail(u, cfg.hybrid.conv_kernel)}


def _rglru_cut(p, x_rows, cfg: ModelConfig, tp):
    """(the rows of the block's output, the scan's last h, the input
    projection before the conv) under the cut."""
    x = tp.gather_seq(x_rows)
    gate = _gelu(x @ p["w_gate"])
    u_in = x @ p["w_in"]
    a, b = _gates_cut(p, _conv1d(u_in, p["conv"]), tp)
    h, h_last = lru_ops.lru_scan(a, b)
    y = gate.float() * h.float()
    return tp.leave(y.to(x.dtype) @ p["w_out"], tp.lru), h_last, u_in


def _gates_cut(p, u: torch.Tensor, tp):
    """:func:`_gates` on the rank's block of the width: ``wr`` and ``wi``
    are placed on their input dim, so the rank's products are partial
    sums over the width, reduce-scattered along it."""
    if not tp.lru:
        return _gates(p, u)
    uf = u.float()
    return _gate_values(uf, tp.scatter_cols(uf @ p["wr"].float()),
                        tp.scatter_cols(uf @ p["wi"].float()),
                        tp.cols(p["br"]), tp.cols(p["bi"]),
                        tp.cols(p["a_log"]))


def rglru_cache_specs(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    hb = cfg.hybrid
    w = hb.lru_width or cfg.d_model
    k = hb.conv_kernel
    return {
        "h": ParamSpec((batch, w), ("batch", "lru"), torch.float32, "zeros"),
        "conv": ParamSpec((batch, k - 1, w), ("batch", None, "lru"), dtype,
                          "zeros"),
    }


def rglru_decode_step(p, x: torch.Tensor, cfg: ModelConfig, cache: Dict
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d). Returns (out (b, 1, d), the new state {h, conv}); the
    caller writes the state into its cache."""
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    new_conv = torch.cat([cache["conv"].to(u.dtype), u], dim=1)[:, 1:]
    u = _conv1d(u, p["conv"], state=cache["conv"])
    a, b = _gates(p, u)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = gate[:, 0].float() * h
    out = (y.to(x.dtype) @ p["w_out"])[:, None, :]
    return out, {"h": h, "conv": new_conv}


def rglru_decode_tp(p, x: torch.Tensor, cfg: ModelConfig, tp, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`rglru_decode_step` under the serving cut: `x` (b, 1, d)
    whole on every rank, `cache` the rank's block of the width (as
    :func:`rglru_prefill_tp` leaves it); ``w_out``'s partial sums are
    all-reduced."""
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    new_conv = torch.cat([cache["conv"].to(u.dtype), u], dim=1)[:, 1:]
    a, b = _gates_cut(p, _conv1d(u, p["conv"], state=cache["conv"]), tp)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = gate[:, 0].float() * h
    out = (y.to(x.dtype) @ p["w_out"])[:, None, :]
    return tp.all_reduce(out) if tp.lru else out, {"h": h, "conv": new_conv}
