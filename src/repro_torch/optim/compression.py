"""Narrow-wire gradient codecs: int8 error-feedback for the cross-pod hop,
plus bf16/fp8 wire codecs.

The slow inter-pod link carries gradients quantized to int8 with a
per-tensor scale; the quantization error is fed back into the next step's
gradient (error feedback, cf. 1-bit SGD/EF-SGD), which keeps SGD/Adam
convergence unbiased in practice. Used by
:func:`repro_torch.core.reduction.hierarchical_allreduce` (``compress=``,
``decompress=``): only the cross-pod hop sees compressed payloads.

A codec that shares a scale across a mesh axis takes the mesh beside the
axis name: the reference's ``pmax`` over the axis is an all-reduce MAX over
that axis's line group. ``q`` is computed with a true division by the
scale; XLA may multiply by the reciprocal instead, so at a rounding tie
``q`` may differ from the JAX package's by one (the tests bound it so).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.reduction import process_allreduce

Payload = Dict[str, torch.Tensor]


def _shared_amax(x: torch.Tensor, axis_name: Optional[str], mesh
                 ) -> torch.Tensor:
    """max |x| as f32, MAX-reduced over `axis_name` when one is given."""
    amax = x.abs().max().to(torch.float32)
    if axis_name is None:
        return amax
    if mesh is None:
        raise ValueError(f"sharing the scale over axis {axis_name!r} needs "
                         f"the mesh (mesh=...)")
    return process_allreduce(amax, mesh, axis_name, "max")


def int8_compress(x: torch.Tensor, axis_name: Optional[str] = None,
                  mesh=None) -> Payload:
    """Quantize to int8 values with a per-tensor scale. When `axis_name` is
    given the scale is MAX-shared across that axis of `mesh`, so every
    participant has one scale and the integer sum over the axis is exact.
    ``q`` is int16: the sum of int8-valued entries cannot overflow for <=
    256 participants (127 * 256 = 32512 < 2^15)."""
    amax = _shared_amax(x, axis_name, mesh)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return {"q": q.to(torch.int16), "scale": scale}


def int8_decompress(payload: Payload) -> torch.Tensor:
    return payload["q"].to(torch.float32) * payload["scale"]


def make_crosspod_codec(mesh, axis_name: str):
    """(compress, decompress) pair for hierarchical_allreduce: the scale is
    shared (MAX) across the pod axis; after the hop both ``q`` and the scale
    are sums over the axis, so the scale is divided by the axis size."""

    def compress(x: torch.Tensor) -> Payload:
        return int8_compress(x, axis_name, mesh)

    def decompress(p: Payload) -> torch.Tensor:
        n = mesh.shape[axis_name]
        return p["q"].to(torch.float32) * (p["scale"] / n)

    return compress, decompress


def ef_compress_update(g: torch.Tensor, err: torch.Tensor,
                       axis_name: Optional[str] = None,
                       compress=None, decompress=None, mesh=None
                       ) -> Tuple[Payload, torch.Tensor]:
    """Error-feedback step: compress (g + err); return (payload, new_err).

    Defaults to the int8 codec; pass any (compress, decompress) pair from
    :func:`wire_codec` to error-feed a bf16 or fp8 wire instead."""
    compress = compress or int8_compress
    decompress = decompress or int8_decompress
    target = g.to(torch.float32) + err
    payload = compress(target, axis_name, mesh)
    return payload, target - decompress(payload)


# --------------------------------------------------------- narrow wire dtypes
# bf16 is a pure cast (no scale state; it keeps f32's exponent range); fp8
# (e4m3) carries a shared per-tensor scale like int8 but is NOT exact under
# a sum, so it belongs on point-to-point or gather hops, or with error
# feedback.
_FP8_DTYPE = torch.float8_e4m3fn   # 4-bit exponent / 3-bit mantissa
_FP8_MAX = float(torch.finfo(_FP8_DTYPE).max)   # 448.0


def bf16_compress(x: torch.Tensor, axis_name: Optional[str] = None,
                  mesh=None) -> Payload:
    del axis_name, mesh  # no shared state
    return {"q": x.to(torch.bfloat16)}


def bf16_decompress(payload: Payload) -> torch.Tensor:
    return payload["q"].to(torch.float32)


def fp8_compress(x: torch.Tensor, axis_name: Optional[str] = None,
                 mesh=None) -> Payload:
    """Quantize to float8_e4m3fn with a per-tensor scale (MAX-shared across
    `axis_name`, the same contract as :func:`int8_compress`)."""
    amax = _shared_amax(x, axis_name, mesh)
    scale = torch.clamp(amax, min=1e-12) / _FP8_MAX
    q = (x.to(torch.float32) / scale).to(_FP8_DTYPE)
    return {"q": q, "scale": scale}


def fp8_decompress(payload: Payload) -> torch.Tensor:
    return payload["q"].to(torch.float32) * payload["scale"]


WIRE_CODECS = {
    "bf16": (bf16_compress, bf16_decompress),
    "fp8": (fp8_compress, fp8_decompress),
    "int8": (int8_compress, int8_decompress),
}


def wire_codec(kind: str):
    """(compress, decompress) pair by wire-dtype name: bf16 | fp8 | int8."""
    try:
        return WIRE_CODECS[kind]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {kind!r}; available: "
            f"{', '.join(sorted(WIRE_CODECS))}") from None
