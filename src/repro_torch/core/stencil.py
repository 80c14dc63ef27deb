"""The paper's applications (§4) on the HDOT core, on PyTorch: Heat2D, a
CREAMS-like RK3 multi-direction stencil and HPCCG's CG.

Each solver runs under the two schedules (``mode='two_phase'``, the paper's
MPI+OpenMP baseline, and ``mode='hdot'``) with the same bits. Heat2D runs on
1-D slabs or a 2-D (rows x cols) grid of ranks, with the interior of each
rank's block over-decomposed into chunk tasks (``subdomains=``, the paper's
grainsize knob) that a measured-cost cut may make uneven
(``chunk_weights=``). RK3 and HPCCG decompose the trailing dims of a 3-D
grid: z on slabs, (y, z) on a pair of axes, and (HPCCG) (x, y, z) on three.

There is no jit and no cache of compiled solvers: a call runs eagerly on the
mesh's device, and the per-step residual stays there until the end.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.domain import (Box, _is_extents, decompose_grid,
                                     part_extents)
from repro_torch.core.halo import (HaloExchange, _norm_subn, _pad,
                                   _stack_outs, _start_halo_nd, halo_scan_nd,
                                   multi_dim_stencil, pad_with_halo,
                                   stencil_with_exchange_nd)
from repro_torch.core.reduction import (hdot_reduce, process_allreduce,
                                        task_reduce)
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


def _rank_box(global_shape, mesh, axes, coords, dims=None) -> Box:
    """The block of the global grid that the rank at `coords` owns: the
    partition scheme over the decomposed dims (dim ``dims[k]`` split by
    axis ``axes[k]``; by default dim k by axis k, as Heat2D splits), whole
    along the rest. Ranks that differ only along axes the solver does not
    name hold the same block."""
    dims = tuple(range(len(axes))) if dims is None else tuple(dims)
    if len(dims) != len(axes):
        raise ValueError(f"{len(axes)} mesh axes {axes} but {len(dims)} "
                         f"decomposed dims {dims}")
    parts, idx_of = [1] * len(global_shape), [0] * len(global_shape)
    for d, name in zip(dims, axes):
        n = mesh.shape[name]
        if global_shape[d] % n:
            raise ValueError(
                f"grid dim {d} ({global_shape[d]}) is not divisible by mesh "
                f"axis {name!r} ({n})")
        parts[d] = n
        idx_of[d] = coords[mesh.axis_index(name)]
    idx = 0
    for d in range(len(global_shape)):
        idx = idx * parts[d] + idx_of[d]
    return decompose_grid(tuple(global_shape), parts)[idx]


def local_block(u: torch.Tensor, mesh, mesh_axes,
                dims=None) -> torch.Tensor:
    """This rank's block of the GLOBAL grid `u`, on the mesh's device.
    `dims` names the grid dim each mesh axis splits (default: dim k by
    axis k)."""
    axes = normalize_mesh_axes(mesh_axes, "local_block", (1, 2, 3))
    box = _rank_box(tuple(u.shape), mesh, axes, mesh.coords, dims)
    return u[box.slices()].to(mesh.device)


def gather_global(block: torch.Tensor, mesh, mesh_axes, global_shape,
                  dims=None) -> torch.Tensor:
    """Assemble the global grid from every rank's block (an all-gather of
    the blocks). For tests and the smoke run: a solve returns the local
    block only, so a 1 GiB grid is never all-gathered unless asked for."""
    axes = normalize_mesh_axes(mesh_axes, "gather_global", (1, 2, 3))
    if mesh.size == 1:
        return block
    blocks = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(blocks, block.contiguous())
    out = torch.empty(tuple(global_shape), dtype=block.dtype,
                      device=block.device)
    for r, b in enumerate(blocks):
        box = _rank_box(tuple(global_shape), mesh, axes,
                        rank_coords(r, mesh.sizes), dims)
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


# ========================================== CREAMS-like RK3 stencil (§4.2)
# 8th-order central second-derivative coefficients (halo width 4 == CREAMS
# Nh) and the classic Williamson low-storage RK3 coefficients, held as the
# float32 values the JAX package computes with.
_C8 = tuple(float(c) for c in np.float32(
    [-1 / 560, 8 / 315, -1 / 5, 8 / 5, -205 / 72, 8 / 5, -1 / 5, 8 / 315,
     -1 / 560]))
_RK3_A = tuple(float(c) for c in np.float32([0.0, -5 / 9, -153 / 128]))
_RK3_B = tuple(float(c) for c in np.float32([1 / 3, 15 / 16, 8 / 15]))
_RK3_WIDTH = 4


def _trailing_dims(axes) -> Tuple[int, ...]:
    """The grid dims the 3-D solvers decompose: the trailing ones, z for
    slabs, (y, z) for a pair, (x, y, z) for a triple."""
    return tuple(range(3 - len(axes), 3))


def _check_3d(u: torch.Tensor, solver: str) -> None:
    if u.dim() != 3:
        raise ValueError(f"{solver}: the grid must be 3-D (x, y, z), got "
                         f"shape {tuple(u.shape)}")


def _diff2_dir(padded: torch.Tensor, dim: int) -> torch.Tensor:
    """8th-order d2/dx_dim^2 over a block padded by 4 ghosts along `dim`."""
    n = padded.shape[dim] - 2 * _RK3_WIDTH
    out = None
    for j, c in enumerate(_C8):
        sl = padded.narrow(dim, j, n)
        out = c * sl if out is None else out + c * sl
    return out


def rk3_rhs(v: torch.Tensor, mesh, axes, mode: str,
            nu: float = 0.05) -> torch.Tensor:
    """Direction-split diffusion RHS (stands in for euler_LLF_x/y/z): the
    three per-direction stencils are independent tasks (paper Figure 5),
    each direction padded locally or exchanged on its own mesh axis (the
    trailing dims, one per name in `axes`). Direction-split stencils have no
    cross-dim couplings, so a 2-D mesh needs no corner messages."""
    sharded = dict(zip(_trailing_dims(axes), axes))
    decomp = [(d, sharded.get(d)) for d in range(3)]
    return nu * multi_dim_stencil(v, _diff2_dir, mesh, decomp,
                                  _RK3_WIDTH, periodic=True, mode=mode)


def _rk3_rhs_in_flight(v: torch.Tensor, pending, nu: float = 0.05,
                       subdomains: int = 4) -> torch.Tensor:
    """The RHS with the sharded dims' exchanges in flight (`pending`: dim ->
    :class:`HaloExchange`, ascending dims): the local-pad directions run
    first, then each sharded direction's interior chunks, and only its
    boundary faces wait on its own exchange. The directions add in dim
    order, as :func:`rk3_rhs` adds them, so the bits are the same. The JAX
    package spells the slab and the pair forms as two functions
    (``_rk3_rhs_with_halo`` and ``_rk3_rhs_with_halo_2d``)."""
    local = [(d, None) for d in range(3) if d not in pending]
    total = multi_dim_stencil(v, _diff2_dir, None, local, _RK3_WIDTH,
                              periodic=True)
    for d, ex in pending.items():
        total = total + stencil_with_exchange_nd(
            v, [ex], functools.partial(_diff2_dir, dim=d), _RK3_WIDTH, (d,),
            (subdomains,))
    return nu * total


def _rk3_start(v: torch.Tensor, mesh, axes) -> Dict[int, HaloExchange]:
    """Issue every sharded dim's periodic width-4 exchange of `v`."""
    dims = _trailing_dims(axes)
    return {d: ex for d, ex in zip(dims, _start_halo_nd(
        v, mesh, tuple(zip(axes, dims)), _RK3_WIDTH, True))}


def rk3_local_step(v: torch.Tensor, mesh, axes, dt: float,
                   mode: str) -> torch.Tensor:
    """One 3-stage low-storage RK step (paper Code 8's rk loop): each stage
    is exchange -> per-direction stencils -> update."""
    s = torch.zeros_like(v)
    for a, b in zip(_RK3_A, _RK3_B):
        rhs = rk3_rhs(v, mesh, axes, mode)
        s = a * s + dt * rhs
        v = v + b * s
    return v


def rk3_local_step_pipelined(v: torch.Tensor, pending, mesh, axes,
                             dt: float, subdomains: int = 4,
                             exchange_last: bool = True):
    """RK3 step with the halos carried across stages, on slabs or a (y, z)
    pair alike: each stage consumes the exchanges issued at the END of the
    previous stage and issues the next ones the moment its `v` update
    lands, so every message flies behind the next stage's local-pad
    stencils and interior chunks (Code 8's comm task, double-buffered).
    `exchange_last=False` peels the drain: the solve's final stage feeds no
    consumer. Returns ``(v, pending)``."""
    s = torch.zeros_like(v)
    n_stages = len(_RK3_A)
    for i, (a, b) in enumerate(zip(_RK3_A, _RK3_B)):
        rhs = _rk3_rhs_in_flight(v, pending, subdomains=subdomains)
        s = a * s + dt * rhs
        v = v + b * s
        if exchange_last or i < n_stages - 1:
            pending = _rk3_start(v, mesh, axes)
    return v, pending


def _rk3_run(v: torch.Tensor, mesh, axes, steps: int, dt: float,
             mode: str) -> torch.Tensor:
    """The solver on this rank's block. hdot pipelines the stage halos when
    every sharded dim of the block holds >= 16 cells (four chunks of the
    width-4 stencil) and there is a step to run; else each stage exchanges
    and computes in turn."""
    dims = _trailing_dims(axes)
    if (mode == "hdot" and steps > 0
            and all(v.shape[d] >= 16 for d in dims)):
        pending = _rk3_start(v, mesh, axes)           # pipeline fill
        for step in range(steps):
            # drain peeled: the last step's last-stage exchange is dead
            v, pending = rk3_local_step_pipelined(
                v, pending, mesh, axes, dt, exchange_last=step < steps - 1)
        return v
    for _ in range(steps):
        v = rk3_local_step(v, mesh, axes, dt, mode)
    return v


def rk3_solve(v0: torch.Tensor, mesh, mesh_axes, steps: int,
              dt: float = 0.05, mode: str = "hdot") -> torch.Tensor:
    """Run `steps` RK3 steps of the periodic 8th-order diffusion on the
    GLOBAL (x, y, z) grid `v0`; returns this rank's block, on the mesh's
    device. `mesh_axes` is ``(z_axis,)``, the paper's z-decomposed slabs,
    or a ``(y_axis, z_axis)`` pair, a (y, z) grid of ranks with the stage
    halos carried on both axes. An hdot solve of `s` steps sends exactly
    ``3·s`` exchanges on each axis of size > 1 (one fill, 3 per full step,
    2 in the peeled last step), as many as two_phase; the two schedules
    give the same bits."""
    axes = normalize_mesh_axes(mesh_axes, "rk3_solve", (1, 2))
    _check_3d(v0, "rk3_solve")
    block = local_block(v0, mesh, axes, _trailing_dims(axes))
    return _rk3_run(block, mesh, axes, steps, dt, mode)


# ============================================================ HPCCG CG (§4.3)
def _sum27(q: torch.Tensor) -> torch.Tensor:
    """HPCCG's 27-point operator (diag=26, off-diag=-1) on a fully padded
    (nx+2, ny+2, nz+2) block; returns the (nx, ny, nz) interior."""
    nx, ny, nz = q.shape[0] - 2, q.shape[1] - 2, q.shape[2] - 2
    acc = 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                sl = q[1 + dx:nx + 1 + dx, 1 + dy:ny + 1 + dy,
                       1 + dz:nz + 1 + dz]
                if dx == dy == dz == 0:
                    acc = acc + 26.0 * sl
                else:
                    acc = acc - sl
    return acc


def _chain_fn27(dims: Tuple[int, ...]):
    """27-point apply for a block that ALREADY carries ghosts on every dim
    in `dims` (the last one's supplied by the caller); the other dims are
    padded locally with zeros (global Dirichlet)."""
    pads = [(0, 0) if d in dims else (1, 1) for d in range(3)]

    def fn(block: torch.Tensor) -> torch.Tensor:
        return _sum27(_pad(block, pads))

    return fn


def _exchange_chain(p: torch.Tensor, mesh, axes, dims
                    ) -> Tuple[torch.Tensor, HaloExchange]:
    """Sequential face-message exchange (the MPI ordered-exchange trick,
    chained): pad every decomposed dim but the last IN ORDER, each pad
    shipping the PREVIOUSLY padded block, so its face messages carry the
    earlier dims' edge values from the diagonal ranks through the shared
    neighbours; then issue the LAST dim's exchange of the fully padded
    block and return it in flight. Its halo planes carry every corner
    coupling of the 27-point operator with one face exchange per axis.
    Returns ``(p_padded, last_exchange)``; on slabs it is just the z
    exchange of `p`."""
    for a, d in zip(axes[:-1], dims[:-1]):
        p = pad_with_halo(p, mesh, a, 1, d)
    ex = _start_halo_nd(p, mesh, ((axes[-1], dims[-1]),), 1, False)[0]
    return p, ex


def _stencil27_matvec(p: torch.Tensor, mesh, axes, mode: str,
                      chain=None, subdomains: int = 4) -> torch.Tensor:
    """y = A p for the 27-point operator, the trailing dims of the 3-D grid
    decomposed over `axes` (one, two or three names; ``axes=()`` for one
    undecomposed block). `chain` is the :func:`_exchange_chain` pair, issued
    ahead by the pipelined CG; without it the chain is issued here. hdot
    computes the last dim's interior chunks before it waits on the last
    exchange; only the two boundary planes consume it. The JAX package
    spells slabs (``_stencil27_matvec``) and chains
    (``_stencil27_matvec_chain``) apart; on slabs the chain is the z
    exchange alone, so one function serves both with the same cells and
    operations."""
    if not axes:
        return _sum27(_pad(p, [(1, 1)] * 3))
    dims = _trailing_dims(axes)
    if chain is None:
        chain = _exchange_chain(p, mesh, axes, dims)
    p1, ex = chain
    fn = _chain_fn27(dims)
    if mode == "hdot":
        return stencil_with_exchange_nd(p1, [ex], fn, 1, (dims[-1],),
                                        (subdomains,))
    lo, hi = ex.wait()
    return fn(torch.cat([lo, p1, hi], dim=dims[-1]))


def _ddot(a: torch.Tensor, b: torch.Tensor, mesh, axes,
          subdomains: int = 4) -> torch.Tensor:
    """paper Code 11: per-subdomain reduction(+) partials (the flat product
    cut as ``jnp.array_split`` cuts it, each chunk summed in f32, or f64 for
    f64 inputs), a task-level tree, then one all-reduce over `axes`. Stays
    on the device."""
    prod = (a * b).reshape(-1)
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    partials = [c.sum(dtype=acc)
                for c in torch.tensor_split(prod, subdomains)]
    local = task_reduce(partials, "sum")
    if not axes:
        return local
    return process_allreduce(local, mesh, axes)


def _hpccg_run(b: torch.Tensor, mesh, axes, iters: int, mode: str,
               subdomains: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CG on this rank's block of `b`. hdot (with >= 4 z cells and an
    iteration to run) issues the exchange chain for iteration k+1's matvec
    the moment p_{k+1} is formed; the last iteration's is peeled. alpha,
    beta, rtrans and the history never leave the device."""
    dims = _trailing_dims(axes)
    x = torch.zeros_like(b)
    r = b
    p = r
    rtrans = _ddot(r, r, mesh, axes, subdomains)
    pipelined = mode == "hdot" and b.shape[2] >= 4 and iters > 0
    chain = _exchange_chain(p, mesh, axes, dims) if pipelined else None
    hist = []
    for it in range(iters):
        Ap = _stencil27_matvec(p, mesh, axes, mode, chain, subdomains)
        alpha = rtrans / _ddot(p, Ap, mesh, axes, subdomains)
        x = x + alpha * p          # waxpby tasks
        r = r - alpha * Ap
        rtrans_new = _ddot(r, r, mesh, axes, subdomains)
        beta = rtrans_new / rtrans
        p = r + beta * p
        rtrans = rtrans_new
        if pipelined and it < iters - 1:
            chain = _exchange_chain(p, mesh, axes, dims)  # the NEXT matvec
        hist.append(torch.sqrt(rtrans))
    return x, _stack_outs(hist, rtrans)


def hpccg_solve(b: torch.Tensor, mesh, mesh_axes, iters: int,
                mode: str = "hdot", subdomains: int = 4
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpreconditioned CG on HPCCG's 27-point system for the GLOBAL
    right-hand side `b` (x, y, z); returns (this rank's block of x, the
    residual-norm history of shape (iters,)), both on the mesh's device.

    `mesh_axes` is ``(z_axis,)`` (z-stacked slabs), a ``(y_axis, z_axis)``
    pair, or an ``(x_axis, y_axis, z_axis)`` triple (HPCCG's native 3-D
    mesh); multi-axis meshes carry the operator's corners on the sequential
    face-message chain (:func:`_exchange_chain`). Both schedules send
    `iters` exchanges on each axis of size > 1 and ``2·iters + 1``
    all-reduces on each; hdot launches iteration k+1's chain when p_{k+1}
    is formed, so its last exchange rides behind the two ddot all-reduces,
    the waxpby updates and the next matvec's interior chunks."""
    axes = normalize_mesh_axes(mesh_axes, "hpccg_solve", (1, 2, 3))
    _check_3d(b, "hpccg_solve")
    if mode not in ("hdot", "two_phase", "none"):
        raise ValueError(f"unknown overlap mode {mode!r}")
    block = local_block(b, mesh, axes, _trailing_dims(axes))
    return _hpccg_run(block, mesh, axes, iters, mode, subdomains)


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
