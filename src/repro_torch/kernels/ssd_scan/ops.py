"""Wrapper for the Mamba-2 SSD chunked scan.

``impl="auto"`` launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) for the within-chunk terms of a CUDA tensor and runs
the plain PyTorch version (:mod:`.ref`) for a CPU tensor; ``"plain"``
forces the plain version and ``"kernel"`` on a CPU tensor raises. There is
no fallback from the kernel to the plain version. ``ssd.launches`` counts
the kernel launches (one per call of :func:`ssd` on the kernel path).

On the kernel path the within-chunk terms, when their gradient is wanted,
are a ``torch.autograd.Function`` whose backward is the same source's ``ssd_chunk_bwd`` (their
vector-Jacobian product, recomputing cs, L, C B^T and x dt); the
cross-chunk part stays PyTorch under autograd, as it stays ``jnp`` outside
the Pallas call in the reference. ``ssd.bwd_launches`` counts the
backward's calls. On the CPU autograd differentiates the plain version.

As in the JAX package (``repro/kernels/ssd_scan/ssd_scan.py``), the kernel
computes the chunk-local terms and the short recurrence across chunks and
the off-diagonal term run outside it, in PyTorch
(:func:`~repro_torch.kernels.ssd_scan.ref.ssd_combine`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, needs_grad
from repro_torch.kernels.ssd_scan import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations
MAX_STATE = 256


def _check(x, dt, A, B, C, chunk, initial_state):
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (b, l, h, p); got {tuple(x.shape)}")
    b, l, h, p = x.shape
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,):
        raise ValueError(
            f"ssd: dt must be (b, l, h) = {(b, l, h)} and A (h,) = {(h,)}; "
            f"got {tuple(dt.shape)}, {tuple(A.shape)}")
    if B.dim() != 3 or B.shape != C.shape or tuple(B.shape[:2]) != (b, l):
        raise ValueError(
            f"ssd: B and C must be (b, l, n) with (b, l) = {(b, l)}; got "
            f"{tuple(B.shape)}, {tuple(C.shape)}")
    if chunk < 1 or l < 1:
        raise ValueError(f"ssd: chunk ({chunk}) and length ({l}) must be >= 1")
    n = B.shape[-1]
    if initial_state is not None and tuple(initial_state.shape) != (b, h, p, n):
        raise ValueError(
            f"ssd: initial_state must be (b, h, p, n) = {(b, h, p, n)}; got "
            f"{tuple(initial_state.shape)}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("ssd: inputs on different devices")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int,
        initial_state: Optional[torch.Tensor] = None, impl: str = "auto"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p), dt (b,l,h) [post-softplus], A (h,) [negative], B, C
    (b,l,n); any l. Returns (y (b,l,h,p) in x.dtype, final state (b,h,p,n)
    f32).

    A ragged tail is padded to a chunk multiple with dt = 0 steps: their
    decay is exp(0) = 1 and their input dt x B^T = 0, so the final state is
    exact, and y past l is sliced off (the JAX package's ``ops.ssd``)."""
    _check(x, dt, A, B, C, chunk, initial_state)
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "plain"
    if impl not in ("plain", "kernel"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel" and not x.is_cuda:
        raise ValueError(
            "ssd: impl='kernel' needs CUDA tensors; the CPU runs impl='plain'")
    l = x.shape[1]
    pad = (-l) % chunk
    if pad:
        def padded(t):
            return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])

        y, state = ssd(padded(x), padded(dt), A, padded(B), padded(C), chunk,
                       initial_state, impl)
        return y[:, :l], state
    xc, dtc, Bc, Cc = _ref._chunks(x, dt, B, C, chunk)
    if impl == "plain":
        y_diag, states, decay_chunk, decay_in = _ref.ssd_chunk_terms(
            xc, dtc, A, Bc, Cc)
    else:
        y_diag, states_np, decay_in = chunk_terms_kernel(x, dt, A, B, C,
                                                         chunk)
        states = states_np.transpose(-1, -2)         # (b,c,h,p,n), a view
        decay_chunk = decay_in[:, :, -1, :]
    return _ref.ssd_combine(y_diag, states, decay_chunk, decay_in, Cc,
                            initial_state, x.dtype)


ssd.launches = 0
ssd.bwd_launches = 0


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence (plain PyTorch; the JAX package has no kernel
    there either)."""
    return _ref.ssd_decode_step_ref(state, x_t, dt_t, A, B_t, C_t)


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()  # 16-byte async copies


def _library():
    lib = _build.load(SOURCE)  # nvcc at first use
    if lib.ssd_chunk_fwd.argtypes is None:
        lib.ssd_chunk_fwd.restype = ctypes.c_int
        lib.ssd_chunk_fwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ssd_chunk_bwd.restype = ctypes.c_int
        lib.ssd_chunk_bwd.argtypes = [ctypes.c_void_p] * 14 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
        lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 5
    return lib


def chunk_terms_kernel(x, dt, A, B, C, chunk: int):
    """The CUDA kernel's three outputs, as the Pallas kernel gives them:
    y_diag (b,c,q,h,p), states (b,c,h,n,p) and decay_in (b,c,q,h), all
    float32. The length must be a multiple of `chunk`. Differentiable: the
    backward is the ``ssd_chunk_bwd`` kernel."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk != 0:
        raise ValueError(f"ssd kernel: length {l} is not a multiple of the "
                         f"chunk {chunk}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(
            f"ssd kernel: x, B and C must all be float32 or all bfloat16; "
            f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if p not in HEAD_DIMS or n > MAX_STATE:
        raise ValueError(
            f"ssd kernel: head dim {p} (one of {HEAD_DIMS}) or state size "
            f"{n} (at most {MAX_STATE}) not supported")
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    dt, A = dt.float().contiguous(), A.float().contiguous()
    if needs_grad(x, dt, A, B, C):
        return _ChunkTerms.apply(x, dt, A, B, C, chunk)
    return _launch_fwd(x, dt, A, B, C, chunk)


class _ChunkTerms(torch.autograd.Function):
    """The within-chunk terms under autograd: the forward saves its inputs
    (no copy), the backward launches ``ssd_chunk_bwd``. An output whose
    gradient is None counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _launch_fwd(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dst, ddi):
        x, dt, A, B, C = ctx.saved_tensors
        return (*_launch_bwd(x, dt, A, B, C, ctx.chunk, dy, dst, ddi),
                None)


def _launch_fwd(x, dt, A, B, C, chunk):
    b, l, h, p = x.shape
    n = B.shape[-1]
    c = l // chunk
    fn = _library().ssd_chunk_fwd
    dev = x.device
    y_diag = torch.empty((b, c, chunk, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, c, h, n, p), dtype=torch.float32, device=dev)
    decay_in = torch.empty((b, c, chunk, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y_diag.data_ptr(), states.data_ptr(),
                 decay_in.data_ptr(), b, c, chunk, h, p, n, _DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd.launches += 1
    return y_diag, states, decay_in


def _launch_bwd(x, dt, A, B, C, chunk, dy, dst, ddi):
    """(dx, ddt, dA, dB, dC) from the ``ssd_chunk_bwd`` kernel, for the
    cotangents of y_diag (b,c,q,h,p), states (b,c,h,n,p) and decay_in
    (b,c,q,h); a None cotangent is zero."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    c = l // chunk
    dev = x.device
    lib = _library()

    def cot(t, shape):
        return (torch.zeros(shape, dtype=torch.float32, device=dev)
                if t is None else t.float().contiguous())

    dy = cot(dy, (b, c, chunk, h, p))
    dst = cot(dst, (b, c, h, n, p))
    ddi = cot(ddi, (b, c, chunk, h))
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    work = torch.empty(lib.ssd_chunk_bwd_workspace(b, c, chunk, h, n),
                       dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dst.data_ptr(), ddi.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), work.data_ptr(), b, c, chunk, h, p, n,
            _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan backward kernel launch failed: CUDA error {err}")
    ssd.bwd_launches += 1
    return dx, ddt, dA, dB, dC
