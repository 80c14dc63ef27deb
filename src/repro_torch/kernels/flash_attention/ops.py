"""Wrapper for blocked online-softmax GQA attention (flash attention, fwd).

``impl="auto"`` launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) for a CUDA tensor and runs the plain PyTorch
version (:mod:`.ref`) for a CPU tensor; ``"plain"`` forces the plain version
and ``"kernel"`` on a CPU tensor raises. There is no fallback from the
kernel to the plain version. ``flash_attention.launches`` counts the kernel
launches.

Any ``sq`` and ``sk`` are taken (the kernel masks its ragged tail); the
Pallas kernel's ``sq % block_q == 0`` is a BlockSpec limit, not part of the
function. Positions are ``arange`` on both sides, as in the Pallas kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v must be 4-D (b, s, h, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k and v must be (b, sk, hkv, d) = "
            f"({b}, sk, hkv, {d}); got {tuple(k.shape)}, {tuple(v.shape)}")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(
            f"flash_attention: q heads ({hq}) must be a multiple of kv "
            f"heads ({hkv})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must all be float32 or all bfloat16; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} not supported (one of "
            f"{HEAD_DIMS})")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v on different devices: {q.device}, "
            f"{k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Attention of q (b, sq, hq, d) over k, v (b, sk, hkv, d): causal
    (``k_pos <= q_pos``) and/or sliding ``window`` (``k_pos > q_pos -
    window``), scale 1/sqrt(d), float32 softmax statistics. A row that sees
    no key is zeros. f32 or bf16 in, q.dtype out."""
    _check(q, k, v)
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "plain":
        return _ref.flash_attention_ref(q, k, v, causal, window)
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError(
                "flash_attention: impl='kernel' needs CUDA tensors; the CPU "
                "runs impl='plain'")
        return _launch(q, k, v, causal, window)
    raise ValueError(f"unknown impl {impl!r}")


flash_attention.launches = 0


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()  # 16-byte async copies


def _clamp_int(window):
    # windows past int32 see every key: clamping changes no mask
    return 0 if window is None else max(min(int(window), 2**31 - 1), -2**31)


def _kernel_fn():
    fn = _build.load(SOURCE).flash_attention_fwd  # nvcc at first use
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
    return fn


def _launch(q, k, v, causal, window):
    fn = _kernel_fn()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, hq, hkv, d, int(bool(causal)),
                 int(window is not None), _clamp_int(window), _DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out
