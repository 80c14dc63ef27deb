"""Heat2D (paper §4.1) on the HDOT core, on PyTorch.

The same solver under the two schedules (``mode='two_phase'``, the paper's
MPI+OpenMP baseline, and ``mode='hdot'``), on 1-D slabs or a 2-D
(rows x cols) grid of ranks, with the interior of each rank's block
over-decomposed into chunk tasks (``subdomains=``, the paper's grainsize
knob) that a measured-cost cut may make uneven (``chunk_weights=``).

There is no jit and no cache of compiled solvers: a call runs eagerly on the
mesh's device, and the per-step residual stays there until the end.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.domain import (Box, _is_extents, decompose_grid,
                                     part_extents)
from repro_torch.core.halo import _norm_subn, halo_scan_nd
from repro_torch.core.reduction import hdot_reduce
from repro_torch.launch.mesh import rank_coords, resolve_device


def normalize_mesh_axes(mesh_axes, solver: str,
                        arities: Tuple[int, ...]) -> Tuple[str, ...]:
    """THE solver mesh-topology contract: ``mesh_axes`` is a tuple of mesh
    axis names, one per decomposed grid dim, its arity selecting the
    topology (1 = the paper's slabs, 2 = grid meshes). The JAX package's
    deprecated bare-string spelling has no counterpart: it raises here like
    any other value out of contract."""
    if isinstance(mesh_axes, str):
        raise ValueError(
            f"{solver}: mesh_axes must be a tuple of mesh axis names, e.g. "
            f"({mesh_axes!r},), got the bare string {mesh_axes!r}")
    try:
        axes = tuple(mesh_axes)
    except TypeError:
        raise ValueError(
            f"{solver}: mesh_axes must be a tuple of mesh axis names, "
            f"got {mesh_axes!r}") from None
    if not all(isinstance(a, str) for a in axes):
        raise ValueError(
            f"{solver}: mesh_axes entries must be mesh axis names (str), "
            f"got {axes!r}")
    if len(axes) not in arities:
        want = " or ".join(str(a) for a in arities)
        raise ValueError(
            f"{solver}: mesh_axes takes {want} axis name(s), got "
            f"{len(axes)}: {axes!r}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"{solver}: mesh_axes repeats an axis: {axes!r}")
    return axes


# =============================================================== Heat2D (§4.1)
def _jacobi_stencil(padded: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """5-point Jacobi update. `padded` has 1 ghost row on both ends of dim 0;
    dim 1 uses Dirichlet-0 global boundaries (zero pad)."""
    if dim != 0:
        raise ValueError(f"the slab stencil decomposes dim 0, got dim={dim}")
    p = F.pad(padded, (1, 1))
    return 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def _jacobi_stencil_2d(padded: torch.Tensor) -> torch.Tensor:
    """5-point Jacobi on a block padded by 1 ghost cell on BOTH dims (the
    2-D-mesh contract; corner ghosts are dead — the star never reads them)."""
    return 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                   + padded[1:-1, :-2] + padded[1:-1, 2:])


def _heat2d_residual(mesh, axes, subdomains: int):
    """paper-Code-5 residual: task-level subdomain MAX partials over row
    chunks -> all-reduce MAX over the named axes. Stays on the device."""
    def residual(u_new, u):
        diff = (u_new - u).abs()
        chunks = torch.tensor_split(diff, subdomains, dim=0)
        partials = [c.amax() for c in chunks]
        return hdot_reduce(partials, mesh, axes, op="max")
    return residual


def _heat2d_cuts(global_shape, mesh, axes, subdomains, chunk_weights):
    """Canonicalize per-dim measured chunk costs into the cut tuple the
    solver runs. Each entry of `chunk_weights` is None (uniform), per-cell
    costs over the LOCAL block's interior extent, or explicit chunk extents.
    Returns None when the resolved cut IS the uniform one, exactly as the
    JAX package does (there it keys the compiled-solver cache)."""
    if chunk_weights is None:
        return None
    w = 1
    subs = _norm_subn(subdomains, len(axes))
    entries = list(chunk_weights)
    if len(entries) != len(axes):
        raise ValueError(
            f"heat2d_solve: chunk_weights names {len(entries)} dims but the "
            f"decomposition is {len(axes)}-dimensional")
    out = []
    is_default = []
    for d, (name, k, entry) in enumerate(zip(axes, subs, entries)):
        n_local = global_shape[d] // mesh.shape[name]
        inner = max(0, n_local - 2 * w)
        kd = max(1, min(k, inner // (2 * w)))  # the clamped default count
        if entry is None:
            out.append(None)
            is_default.append(True)
            continue
        entry = tuple(entry)
        # len == interior extent reads as per-cell costs (uniform integer
        # costs sum to the extent and would otherwise masquerade as a grid
        # of 1-cell chunk extents); any other length must be explicit extents
        if len(entry) != inner and _is_extents(entry, len(entry), inner):
            out.append(tuple(int(v) for v in entry))
        else:
            out.append(part_extents(inner, kd, entry))
        is_default.append(out[-1] == part_extents(inner, kd, None))
    # a re-cut that lands back on the default uniform grid IS no cut
    if all(is_default):
        return None
    return tuple(out)


def _rank_box(global_shape, mesh, axes, coords) -> Box:
    """The block of the global grid that the rank at `coords` owns: the
    partition scheme over the decomposed dims (dim d split by axis
    ``axes[d]``), whole along the rest. Ranks that differ only along axes
    the solver does not name hold the same block."""
    parts = [1] * len(global_shape)
    for d, name in enumerate(axes):
        n = mesh.shape[name]
        if global_shape[d] % n:
            raise ValueError(
                f"grid dim {d} ({global_shape[d]}) is not divisible by mesh "
                f"axis {name!r} ({n})")
        parts[d] = n
    idx = 0
    for d in range(len(global_shape)):
        c = coords[mesh.axis_index(axes[d])] if d < len(axes) else 0
        idx = idx * parts[d] + c
    return decompose_grid(tuple(global_shape), parts)[idx]


def local_block(u: torch.Tensor, mesh, mesh_axes) -> torch.Tensor:
    """This rank's block of the GLOBAL grid `u`, on the mesh's device."""
    axes = normalize_mesh_axes(mesh_axes, "local_block", (1, 2))
    box = _rank_box(tuple(u.shape), mesh, axes, mesh.coords)
    return u[box.slices()].to(mesh.device)


def gather_global(block: torch.Tensor, mesh, mesh_axes,
                  global_shape) -> torch.Tensor:
    """Assemble the global grid from every rank's block (an all-gather of
    the blocks). For tests and the smoke run: a solve returns the local
    block only, so a 1 GiB grid is never all-gathered unless asked for."""
    axes = normalize_mesh_axes(mesh_axes, "gather_global", (1, 2))
    if mesh.size == 1:
        return block
    blocks = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(blocks, block.contiguous())
    out = torch.empty(tuple(global_shape), dtype=block.dtype,
                      device=block.device)
    for r, b in enumerate(blocks):
        box = _rank_box(tuple(global_shape), mesh, axes,
                        rank_coords(r, mesh.sizes))
        out[box.slices()] = b
    return out


def _heat2d_run(block: torch.Tensor, mesh, axes, iters: int, mode: str,
                subdomains, cuts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solver on this rank's block (no cut, no gather)."""
    subs = _norm_subn(subdomains, len(axes))
    hs_axes = tuple((a, d) for d, a in enumerate(axes))
    stencil_fn = _jacobi_stencil_2d if len(axes) == 2 else _jacobi_stencil
    return halo_scan_nd(
        block, stencil_fn, mesh, hs_axes, width=1, steps=iters,
        periodic=False, mode=mode, subdomains=subs,
        step_out_fn=_heat2d_residual(mesh, axes, math.prod(subs)),
        weights=cuts)


def heat2d_solve(u0: torch.Tensor, mesh, mesh_axes, iters: int,
                 mode: str = "hdot", subdomains=4,
                 chunk_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `iters` sweeps; returns (this rank's final block, residual
    history of shape (iters,)) — both on the mesh's device.

    `u0` is the GLOBAL grid, as in the JAX package; each rank cuts its
    block by the partition scheme. `mesh_axes` is one mesh axis name per
    decomposed grid dim:

      * ``(axis,)`` — the paper's horizontal slabs (1-D, dim 0),
      * ``(rows_axis, cols_axis)`` — 2-D block decomposition.

    The result is the local block, not the global grid: at real size the
    grid is GiBs and an all-gather per solve would cost more than the solve;
    :func:`gather_global` assembles it when a caller needs it.

    `chunk_weights` (per decomposed dim: None, per-cell measured costs over
    the local interior, or explicit chunk extents) re-cuts the interior
    chunk grid by measured cost; a cut changes the schedule, never the
    numbers."""
    axes = normalize_mesh_axes(mesh_axes, "heat2d_solve", (1, 2))
    if isinstance(subdomains, list):
        subdomains = tuple(subdomains)
    cuts = _heat2d_cuts(tuple(u0.shape), mesh, axes, subdomains,
                        chunk_weights)
    return _heat2d_run(local_block(u0, mesh, axes), mesh, axes, iters, mode,
                       subdomains, cuts)


def heat2d_init(nx: int, ny: int, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Hot square blob in the middle, Dirichlet-0 edges."""
    u = torch.zeros((nx, ny), dtype=dtype, device=resolve_device(device))
    cx, cy, w = nx // 2, ny // 2, max(1, nx // 8)
    u[cx - w:cx + w, cy - w:cy + w] = 1.0
    return u


# ============================================ carrying state across packages
def grid_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (e.g. ``np.asarray`` of a JAX grid) as a tensor on
    `device`, same dtype and values."""
    return torch.tensor(np.asarray(a), device=resolve_device(device))


@dataclass
class Heat2DState:
    """Everything a Heat2D solve carries: the grid, the per-axis halo strips
    ``[(lo, hi), ...]`` and the interior chunk cut (per-dim extents or None
    for uniform). There are no parameters."""

    grid: torch.Tensor
    halos: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    cuts: Optional[Tuple[Optional[Tuple[int, ...]], ...]] = None


def state_from_jax(grid, halos=None, cuts=None, device="cuda") -> Heat2DState:
    """The JAX side's state — numpy arrays (``np.asarray`` of its jax
    arrays) and cut tuples — as the port's tensors on `device`, so both
    packages compute from the same bits."""
    dev = resolve_device(device)
    hs = None
    if halos is not None:
        hs = [(grid_from_numpy(lo, dev), grid_from_numpy(hi, dev))
              for lo, hi in halos]
    cs = None
    if cuts is not None:
        cs = tuple(None if c is None else tuple(int(v) for v in c)
                   for c in cuts)
    return Heat2DState(grid_from_numpy(grid, dev), hs, cs)
