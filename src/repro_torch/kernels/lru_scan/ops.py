"""Wrapper for the gated linear recurrence scan ``h_t = a_t h_{t-1} + b_t``.

``impl="auto"`` launches the hand-written Hopper kernel
(``csrc/lru_scan.cu``) for a CUDA tensor and runs the plain PyTorch version
(:mod:`.ref`) for a CPU tensor; ``"plain"`` forces the plain version and
``"kernel"`` on a CPU tensor raises. There is no fallback from the kernel to
the plain version. On the kernel path a scan whose gradient is wanted is
a ``torch.autograd.Function`` whose backward is the same source's
``lru_scan_bwd`` kernel (the reverse recurrence), so a CUDA tensor is
trained through kernels only; on the CPU autograd differentiates the plain
version. ``lru_scan.launches`` counts the forward kernel's launches and
``lru_scan.bwd_launches`` the backward's.

Any sequence length is taken. The Pallas kernel raises unless its chunk
(``min(256, seq)``) divides the length, so on a TPU the JAX package cannot
prefill, say, a 1000-token prompt through it (``ROADMAP.md`` Queue 3).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, needs_grad
from repro_torch.kernels.lru_scan import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, b, h0):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(
            f"lru_scan: a and b must be (batch, seq, width) of one shape; "
            f"got {tuple(a.shape)}, {tuple(b.shape)}")
    if min(a.shape) < 1:
        raise ValueError(f"lru_scan: empty input {tuple(a.shape)}")
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(
            f"lru_scan: a and b must be float32 or bfloat16; got {a.dtype}, "
            f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(
            f"lru_scan: a and b on different devices: {a.device}, {b.device}")
    if h0 is not None:
        if tuple(h0.shape) != (a.shape[0], a.shape[2]):
            raise ValueError(
                f"lru_scan: h0 must be (batch, width) = "
                f"{(a.shape[0], a.shape[2])}; got {tuple(h0.shape)}")
        if h0.device != a.device:
            raise ValueError(
                f"lru_scan: h0 on {h0.device}, a and b on {a.device}")


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (batch, seq, width), f32 or bf16; h0: (batch, width) or None.
    The carry is float32. Returns (h in b.dtype, h_last (batch, width)
    f32)."""
    _check(a, b, h0)
    if impl == "auto":
        impl = "kernel" if a.is_cuda else "plain"
    if impl == "plain":
        return _ref.lru_scan_ref(a, b, h0)
    if impl == "kernel":
        if not a.is_cuda:
            raise ValueError(
                "lru_scan: impl='kernel' needs CUDA tensors; the CPU runs "
                "impl='plain'")
        if needs_grad(a, b, h0):
            return _Scan.apply(a, b, h0)
        return _launch(a, b, h0)
    raise ValueError(f"unknown impl {impl!r}")


lru_scan.launches = 0
lru_scan.bwd_launches = 0
lru_scan.last_plan = None   # launch shape of the last kernel call


class _Scan(torch.autograd.Function):
    """The kernel scan under autograd: the forward saves a, h and h0 (no
    copy), the backward launches ``lru_scan_bwd``. A gradient that does
    not reach h or h_last counts as zero."""

    @staticmethod
    def forward(ctx, a, b, h0):
        a = a.contiguous()
        h, h_last = _launch(a, b, h0)
        ctx.set_materialize_grads(False)
        ctx.h0_dtype = None if h0 is None else h0.dtype
        ctx.save_for_backward(a, h, None if h0 is None else h0.float())
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = _launch_bwd(a, h, h0, dh, dh_last)
        return da, db, None if h0 is None else dh0.to(ctx.h0_dtype)


def _library():
    lib = _build.load(SOURCE)  # nvcc at first use
    if lib.lru_scan_fwd.argtypes is None:
        lib.lru_scan_fwd.restype = ctypes.c_int
        lib.lru_scan_fwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lru_scan_bwd.restype = ctypes.c_int
        lib.lru_scan_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lru_scan_plan.restype = None
        lib.lru_scan_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def kernel_plan(seq_len: int) -> dict:
    """The kernel's launch shape for a sequence length, from the length
    alone: blocks of a cluster along the sequence, warps a block, steps a
    thread. Builds the kernel at first use."""
    out = (ctypes.c_int * 3)()
    _library().lru_scan_plan(int(seq_len), out)
    return {"cluster": out[0], "warps": out[1], "steps": out[2]}


def _launch(a, b, h0):
    fn = _library().lru_scan_fwd
    a, b = a.contiguous(), b.contiguous()
    bsz, l, w = a.shape
    h = torch.empty_like(b)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    h0 = None if h0 is None else h0.float().contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), bsz, l, w, _DTYPES[a.dtype],
                 _DTYPES[b.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error {err}")
    lru_scan.launches += 1
    lru_scan.last_plan = kernel_plan(l)
    return h, h_last


def _launch_bwd(a, h, h0, dh, dh_last):
    """(da in a.dtype, db in h.dtype, dh0 f32 or None) from the kernel's
    reverse scan; dh and dh_last may be None (zero)."""
    fn = _library().lru_scan_bwd
    bsz, l, w = a.shape
    dh = (torch.zeros_like(h) if dh is None
          else dh.to(h.dtype).contiguous())
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    da = torch.empty_like(a)
    db = torch.empty_like(h)
    dh0 = (None if h0 is None else
           torch.empty((bsz, w), dtype=torch.float32, device=a.device))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(),
                 ptr(dh_last), da.data_ptr(), db.data_ptr(), ptr(dh0), bsz,
                 l, w, _DTYPES[a.dtype], _DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"lru_scan backward kernel launch failed: CUDA error {err}")
    lru_scan.bwd_launches += 1
    return da, db, dh0
