"""Wrapper for the blocked red-black Gauss-Seidel tile sweep.

``impl="auto"`` launches the hand-written Hopper kernel
(``csrc/heat2d.cu``) for a CUDA tensor and runs the plain PyTorch version
(:mod:`.ref`) for a CPU tensor; ``"plain"`` forces the plain version and
``"kernel"`` on a CPU tensor raises. There is no fallback from the kernel to
the plain version. ``heat2d_sweep.launches`` counts the kernel calls (one
a call, whichever path ran); ``heat2d_sweep.last_path`` names the kernel's
path of the last one: "cluster_smem" (a tile held in the shared memory of a
thread-block cluster, one launch) or "global" (a tile too large for that,
swept in global memory). :func:`kernel_plan` says which path a tile takes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.halo import exchange_halo_nd
from repro_torch.core.stencil import local_block
from repro_torch.kernels import _build
from repro_torch.kernels.heat2d import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "heat2d.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _clamp_tile(shape, tile):
    nx, ny = shape
    tx, ty = min(tile[0], nx), min(tile[1], ny)
    if tx < 1 or ty < 1 or nx % tx != 0 or ny % ty != 0:
        raise ValueError(
            f"heat2d: grid shape {tuple(shape)} is not divisible by tile "
            f"{(tx, ty)} (requested tile={tuple(tile)})")
    return tx, ty


def _check_halo(halo, nx, ny):
    if halo is None:
        return None
    hn, hs, hw, he = halo
    if not (tuple(hn.shape) == tuple(hs.shape) == (1, ny)):
        raise ValueError(
            f"heat2d: north/south halo strips must be shape {(1, ny)} "
            f"for grid {(nx, ny)}; got {tuple(hn.shape)} / {tuple(hs.shape)}")
    if not (tuple(hw.shape) == tuple(he.shape) == (nx, 1)):
        raise ValueError(
            f"heat2d: west/east halo strips must be shape {(nx, 1)} "
            f"for grid {(nx, ny)}; got {tuple(hw.shape)} / {tuple(he.shape)}")
    return hn, hs, hw, he


def heat2d_sweep(u: torch.Tensor, tile=(256, 256), sweeps: int = 1,
                 impl: str = "auto", halo=None) -> torch.Tensor:
    """`sweeps` red-black Gauss-Seidel passes over every tile of the local
    block `u` (nx, ny); across tiles the sweep is block-Jacobi. The tile is
    clamped to the grid and must divide it. `halo=(north, south, west,
    east)` — shapes (1, ny), (1, ny), (nx, 1), (nx, 1) — is the block's
    outer ghost ring (one shard of a 2-D mesh); None is the global
    Dirichlet-0 boundary. f32 or bf16 in, computed in f32, u.dtype out."""
    if u.dim() != 2:
        raise ValueError(f"heat2d: u must be 2-D, got shape {tuple(u.shape)}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"heat2d: dtype {u.dtype} not supported "
                         f"(float32 or bfloat16)")
    if sweeps < 0:
        raise ValueError(f"heat2d: sweeps must be >= 0, got {sweeps}")
    nx, ny = u.shape
    tx, ty = _clamp_tile(u.shape, tile)
    halo = _check_halo(halo, nx, ny)
    if impl == "auto":
        impl = "kernel" if u.is_cuda else "plain"
    if impl == "plain":
        return _ref.heat2d_sweep_blocked(u, (tx, ty), sweeps, halo)
    if impl == "kernel":
        if not u.is_cuda:
            raise ValueError(
                "heat2d: impl='kernel' needs a CUDA tensor; the CPU runs "
                "impl='plain'")
        return _launch(u, tx, ty, sweeps, halo)
    raise ValueError(f"unknown impl {impl!r}")


heat2d_sweep.launches = 0
heat2d_sweep.last_path = None   # "cluster_smem" or "global", kernel calls only
heat2d_sweep.last_cluster = 0   # blocks a tile is split over (0: global)


def _library():
    lib = _build.load(SOURCE)  # nvcc at first use
    if lib.heat2d_sweep.argtypes is None:
        lib.heat2d_sweep.restype = ctypes.c_int
        lib.heat2d_sweep.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.heat2d_plan.restype = ctypes.c_int
        lib.heat2d_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    return lib


def kernel_plan(tile):
    """The kernel's path for a (clamped) tile, from its shape alone:
    ("cluster_smem", blocks a tile is split over, shared memory a block)
    or ("global", 0, 0). Builds the kernel at first use."""
    smem = ctypes.c_longlong(0)
    nc = _library().heat2d_plan(int(tile[0]), int(tile[1]),
                                ctypes.byref(smem))
    return ("cluster_smem" if nc else "global"), nc, smem.value


def _launch(u, tx, ty, sweeps, halo):
    lib = _library()
    path, nc, _ = kernel_plan((tx, ty))
    u = u.contiguous()
    if u.data_ptr() % 16:   # the kernel loads 16-byte (bf16: 8-byte) runs
        u = u.clone()
    nx, ny = u.shape
    out = torch.empty_like(u)
    work = None   # the global path's f32 working grid
    if path == "global":
        work = out if u.dtype == torch.float32 else torch.empty(
            (nx, ny), dtype=torch.float32, device=u.device)
    strips = [None] * 4
    if halo is not None:
        strips = [h.to(device=u.device, dtype=torch.float32).contiguous()
                  for h in halo]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.heat2d_sweep(ptr(u), ptr(out), ptr(work),
                               *[ptr(s) for s in strips], nx, ny, tx, ty,
                               sweeps, _DTYPES[u.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"heat2d kernel launch failed ({path} path, cluster {nc}): "
            f"CUDA error {err}")
    heat2d_sweep.launches += 1
    heat2d_sweep.last_path, heat2d_sweep.last_cluster = path, nc
    return out


def heat2d_sweep_sharded(u: torch.Tensor, mesh, axis_names=("rows", "cols"),
                         tile=(256, 256), sweeps: int = 1,
                         impl: str = "auto") -> torch.Tensor:
    """The tile sweep as one level of a 2-D hierarchy: the GLOBAL grid `u`
    is block-decomposed over a (rows x cols) mesh, each rank exchanges both
    axes' width-1 edge strips (corner-free: the 5-point star never reads
    corners), and the sweep stages them as its halo ring exactly like
    neighbour-tile strips. Tiles are the task-level subdomains, ranks the
    process-level ones. Returns this rank's block (see
    :func:`repro_torch.core.stencil.gather_global`)."""
    ar, ac = axis_names
    block = local_block(u, mesh, (ar, ac))
    (north, south), (west, east) = exchange_halo_nd(
        block, mesh, ((ar, 0), (ac, 1)), width=1, periodic=False)
    return heat2d_sweep(block, tile, sweeps, impl,
                        halo=(north, south, west, east))
