"""Halo exchange with interior/boundary overlap (paper §3.2, Figure 3).

The N-D family of ``repro.core.halo`` on ``torch.distributed`` ranks. Two
schedules over the same decomposition:

- ``two_phase`` — the paper's MPI+OpenMP baseline: exchange ALL halos, then
  compute the whole block.
- ``hdot`` — the block is over-decomposed into 2·N boundary faces (the only
  consumers of the halos) and an N-D grid of interior chunk tasks cut by the
  SAME partition scheme the process mesh was cut with
  (:func:`repro_torch.core.domain.interior_boxes`).

Where the JAX package leaves the overlap to XLA's scheduler, here it is
structural. Messages are ``dist.P2POp`` batches to the grid neighbours
(:func:`start_exchange` returns the exchange in flight); in
:func:`halo_scan_nd` the sends and receives for step k+1 are issued right
after step k's faces, BEFORE its interior chunks, and are waited on only
before step k+1's faces. On CUDA the NCCL messages run on their own stream
while the interior chunks run on the compute stream. The last step is peeled:
an hdot solve of `s` steps issues exactly `s` exchanges per axis of size > 1
(one pipeline fill plus `s - 1` in the loop) and none on an axis of size 1.

``axes`` is a tuple of ``(axis_name, dim)`` pairs, one per decomposed array
dim, and the functions that send take the :class:`ProcessMesh` that names
those axes. ``stencil_fn(padded)`` consumes a block padded by `width` ghost
cells on both ends of every decomposed dim and returns the un-padded update.
Star stencils only: corner ghosts are zeros and never exchanged (HPCCG's
27-point corners ride the sequential face-message chain in
:mod:`repro_torch.core.stencil`, built on :func:`pad_with_halo`). The
deprecated 1-D/2-D aliases of the JAX package have no counterpart here.

:func:`stencil_with_exchange_nd` is the consumer side of a pipelined solver
(the RK3 stage and the CG matvec): it takes the exchanges still IN FLIGHT,
computes the interior chunk grid first, and only then waits and computes the
2·N faces, so the messages that left at the end of the previous stage or
iteration hide behind the interior. :func:`multi_dim_stencil` applies a
direction-split stencil (CREAMS' per-direction fluxes) one direction at a
time, each direction padded locally or exchanged on its own axis.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.domain import interior_boxes

# One decomposed dim: (mesh_axis_name, array_dim).
Axes = Sequence[Tuple[str, int]]
StencilFn = Callable[[torch.Tensor], torch.Tensor]

# Message tags: forward (hi edge -> next rank's lo halo) and backward. On
# periodic axes of size 2 both messages go to the same peer; the tags keep
# them apart on gloo, and the fixed issue order (fwd send, bwd send, fwd recv,
# bwd recv on every rank) keeps them apart on NCCL, which matches in order.
_FWD, _BWD = 0, 1


def _sl(u: torch.Tensor, dim: int, a: int, b: int) -> torch.Tensor:
    return u.narrow(dim, a, b - a)


def _pad(u: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad with per-dim (lo, hi) pairs (``jnp.pad`` spelling)."""
    flat = []
    for lo, hi in reversed(list(pads)):
        flat += [lo, hi]
    if not any(flat):
        return u
    return F.pad(u, flat)


def _edge(u: torch.Tensor, dim: int, side: str, width: int) -> torch.Tensor:
    n = u.shape[dim]
    if side == "lo":
        return _sl(u, dim, 0, width)
    return _sl(u, dim, n - width, n)


class HaloExchange:
    """One axis's edge exchange in flight; :meth:`wait` returns
    ``(lo_halo, hi_halo)`` once the messages have landed (on CUDA: once
    the current stream is ordered after them)."""

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor, works=(),
                 sent=()):
        self._lo, self._hi, self._works = lo, hi, list(works)
        self._sent = sent  # the sent edges live until the messages land

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        for w in self._works:
            w.wait()
        self._works, self._sent = [], ()
        return self._lo, self._hi


def start_exchange(lo_edge: torch.Tensor, hi_edge: torch.Tensor, mesh,
                   axis_name: str, periodic: bool = False) -> HaloExchange:
    """Issue the sends and receives of one axis's edge strips and return at
    once. The lo halo is the PREVIOUS rank's hi edge, the hi halo the NEXT
    rank's lo edge. Non-periodic end ranks receive zeros; a size-1 axis sends
    nothing (periodic: its own edges swapped; else zeros)."""
    n = mesh.shape[axis_name]
    if n == 1:
        if periodic:
            return HaloExchange(hi_edge, lo_edge)
        return HaloExchange(torch.zeros_like(hi_edge),
                            torch.zeros_like(lo_edge))
    prev, nxt = mesh.neighbors(axis_name, periodic)
    # column edges are strided views: send and receive contiguous buffers
    lo_edge, hi_edge = lo_edge.contiguous(), hi_edge.contiguous()

    def buf(like, peer):
        alloc = torch.empty if peer is not None else torch.zeros
        return alloc(like.shape, dtype=like.dtype, device=like.device)

    lo_halo, hi_halo = buf(hi_edge, prev), buf(lo_edge, nxt)
    ops = []
    if nxt is not None:
        ops.append(dist.P2POp(dist.isend, hi_edge, nxt, tag=_FWD))
    if prev is not None:
        ops.append(dist.P2POp(dist.isend, lo_edge, prev, tag=_BWD))
    if prev is not None:
        ops.append(dist.P2POp(dist.irecv, lo_halo, prev, tag=_FWD))
    if nxt is not None:
        ops.append(dist.P2POp(dist.irecv, hi_halo, nxt, tag=_BWD))
    works = dist.batch_isend_irecv(ops)
    return HaloExchange(lo_halo, hi_halo, works, (lo_edge, hi_edge))


def exchange_edges(lo_edge: torch.Tensor, hi_edge: torch.Tensor, mesh,
                   axis_name: str, periodic: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange pre-sliced edge strips; returns (lo_halo, hi_halo)."""
    return start_exchange(lo_edge, hi_edge, mesh, axis_name, periodic).wait()


def exchange_halo(u: torch.Tensor, mesh, axis_name: str, width: int,
                  dim: int, periodic: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (lo_halo, hi_halo): the neighbour edges this rank receives."""
    return exchange_edges(_edge(u, dim, "lo", width),
                          _edge(u, dim, "hi", width), mesh, axis_name,
                          periodic)


def pad_with_halo(u: torch.Tensor, mesh, axis_name: str, width: int,
                  dim: int, periodic: bool = False) -> torch.Tensor:
    """Two-phase building block: ``[lo_halo, u, hi_halo]`` along `dim`."""
    lo, hi = exchange_halo(u, mesh, axis_name, width, dim, periodic)
    return torch.cat([lo, u, hi], dim=dim)


def _norm_subn(subdomains, n: int) -> Tuple[int, ...]:
    """Grainsize knob: an int means the same chunk count on every dim."""
    if isinstance(subdomains, int):
        return (subdomains,) * n
    t = tuple(subdomains)
    if len(t) != n:
        raise ValueError(
            f"subdomains={subdomains!r} has {len(t)} entries but the "
            f"decomposition is {n}-dimensional; pass an int or one chunk "
            f"count per dim")
    return t


def exchange_halo_nd(u: torch.Tensor, mesh, axes: Axes, width: int,
                     periodic: bool = False
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One exchange per decomposed axis, all in flight together; returns
    [(lo_k, hi_k), ...] in `axes` order. Corner ghosts are NOT exchanged."""
    return [p.wait() for p in _start_halo_nd(u, mesh, axes, width, periodic)]


def _start_halo_nd(u: torch.Tensor, mesh, axes: Axes, width: int,
                   periodic: bool) -> List[HaloExchange]:
    return [start_exchange(_edge(u, d, "lo", width),
                           _edge(u, d, "hi", width), mesh, a, periodic)
            for a, d in axes]


def pad_with_halo_nd(u: torch.Tensor, halos, width: int,
                     dims: Sequence[int]) -> torch.Tensor:
    """Assemble the corner-free padded block: face halos on every decomposed
    dim, ZEROS in the corner ghosts (star stencils never read them)."""
    out = u
    for k in reversed(range(len(dims))):
        lo, hi = halos[k]
        pads = [(0, 0)] * u.dim()
        for j in range(k + 1, len(dims)):
            pads[dims[j]] = (width, width)
        out = torch.cat([_pad(lo, pads), out, _pad(hi, pads)], dim=dims[k])
    return out


def _face_src_nd(u: torch.Tensor, halos, k: int, side: str, width: int,
                 dims: Sequence[int]) -> torch.Tensor:
    """Ghost-extended source for face (k, side) — the ONLY consumer of axis
    k's `side` halo. Along earlier dims the face covers the interior range,
    so u's own cells are its ghosts; along later dims it spans the full
    extent, so their halos are stitched in, restricted to this face's cells
    and zero-padded into the corners."""
    w = width
    dk = dims[k]
    nk = u.shape[dk]
    lo_k, hi_k = halos[k]
    if side == "lo":
        cells = (0, 2 * w)          # the u-cells adjacent to this face
        src = torch.cat([lo_k, _sl(u, dk, *cells)], dim=dk)
        zk = (w, 0)                 # where axis k's halo sits inside src
    else:
        cells = (nk - 2 * w, nk)
        src = torch.cat([_sl(u, dk, *cells), hi_k], dim=dk)
        zk = (0, w)
    for j in range(k + 1, len(dims)):
        lo_j, hi_j = halos[j]

        def clip(h):
            h = _sl(h, dk, *cells)
            pads = [(0, 0)] * u.dim()
            pads[dk] = zk                       # corner with axis k: zeros
            for jp in range(k + 1, j):
                pads[dims[jp]] = (width, width)  # corner with axis jp: zeros
            return _pad(h, pads)

        src = torch.cat([clip(lo_j), src, clip(hi_j)], dim=dims[j])
    return src


def _faces_nd(u: torch.Tensor, halos, stencil_fn: StencilFn, width: int,
              dims: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 2·N boundary-face tasks — the only consumers of the halos."""
    return [(stencil_fn(_face_src_nd(u, halos, k, "lo", width, dims)),
             stencil_fn(_face_src_nd(u, halos, k, "hi", width, dims)))
            for k in range(len(dims))]


def _chunk_grid_nd(ext: Sequence[int], width: int,
                   subdomains: Tuple[int, ...], weights) -> Tuple[list, list]:
    """Resolve the interior chunk grid: per-dim chunk counts (`subdomains`
    clamped so uniform chunks stay >= 2*width) plus the optional
    measured-cost cut. `weights` is None or one entry per dim — None
    (uniform) or explicit chunk extents from
    :func:`repro_torch.core.domain.interior_cuts`; an extents entry fixes
    that dim's chunk count and must sum to the interior extent."""
    w = width
    ks = [max(1, min(k, (n - 2 * w) // max(1, 2 * w)))  # keep chunks >= 2w
          for k, n in zip(subdomains, ext)]
    if weights is None:
        return ks, None
    wts = list(weights)
    if len(wts) != len(ext):
        raise ValueError(
            f"weights names {len(wts)} dims but the decomposition is "
            f"{len(ext)}-dimensional — one entry (or None) per dim required")
    for lvl, entry in enumerate(wts):
        if entry is None:
            continue
        entry = tuple(int(v) for v in entry)
        inner = max(0, ext[lvl] - 2 * w)
        if sum(entry) != inner or any(v < 0 for v in entry):
            raise ValueError(
                f"weights[{lvl}]={entry} must be non-negative chunk extents "
                f"summing to the interior extent {inner} (use "
                f"repro_torch.core.domain.interior_cuts to canonicalize "
                f"measured costs)")
        wts[lvl] = entry
        ks[lvl] = len(entry)  # an explicit cut fixes the chunk count
    return ks, wts


def _interior_chunks_nd(u: torch.Tensor, stencil_fn: StencilFn, width: int,
                        dims: Sequence[int], subdomains: Tuple[int, ...],
                        weights=None) -> torch.Tensor:
    """Interior cells [w, n-w) per decomposed dim as an N-D grid of chunk
    tasks cut by `interior_boxes`. A chunk reads only its subdomain plus
    `width` ghosts, so no chunk depends on a message."""
    w = width
    ext = [u.shape[d] for d in dims]
    ks, wts = _chunk_grid_nd(ext, w, subdomains, weights)
    boxes = interior_boxes(ext, w, ks, wts)  # row-major over the ks grid
    outs = []
    for b in boxes:
        src = u
        for lvl, d in enumerate(dims):
            src = _sl(src, d, b.start[lvl] - w, b.stop[lvl] + w)
        outs.append(stencil_fn(src))
    for lvl in range(len(ks) - 1, -1, -1):  # row-major -> nested concat
        k = ks[lvl]
        outs = [outs[i] if k == 1
                else torch.cat(outs[i:i + k], dim=dims[lvl])
                for i in range(0, len(outs), k)]
    return outs[0]


def _assemble_nd(faces, interior: torch.Tensor,
                 dims: Sequence[int]) -> torch.Tensor:
    """Wrap the interior chunk grid in the face outputs, innermost dim out."""
    out = interior
    for k in reversed(range(len(dims))):
        lo, hi = faces[k]
        out = torch.cat([lo, out, hi], dim=dims[k])
    return out


def stencil_with_exchange_nd(u: torch.Tensor, pending: Sequence[HaloExchange],
                             stencil_fn: StencilFn, width: int,
                             dims: Sequence[int], subdomains=2,
                             weights=None) -> torch.Tensor:
    """The JAX package's ``stencil_with_halo_nd`` on exchanges that may
    still be in flight (one :class:`HaloExchange` per dim of `dims`; wrap
    halos already received as ``HaloExchange(lo, hi)``): the interior chunk
    grid runs first, reading only `u`; then the exchanges are waited on and
    the 2·N faces, their only consumers, run. Where the halos arrive changes
    when a cell is computed, never how: same operations, same bits."""
    dims = tuple(dims)
    subdomains = _norm_subn(subdomains, len(dims))
    if any(u.shape[d] < 4 * width for d in dims):  # degenerate: no interior
        halos = [p.wait() for p in pending]
        return stencil_fn(pad_with_halo_nd(u, halos, width, dims))
    interior = _interior_chunks_nd(u, stencil_fn, width, dims, subdomains,
                                   weights)
    halos = [p.wait() for p in pending]
    faces = _faces_nd(u, halos, stencil_fn, width, dims)
    return _assemble_nd(faces, interior, dims)


def stencil_two_phase_nd(u: torch.Tensor, stencil_fn: StencilFn, mesh,
                         axes: Axes, width: int,
                         periodic: bool = False) -> torch.Tensor:
    """comm(all axes); barrier; compute(whole block) — paper Code 2."""
    dims = tuple(d for _, d in axes)
    halos = exchange_halo_nd(u, mesh, axes, width, periodic)
    return stencil_fn(pad_with_halo_nd(u, halos, width, dims))


def stencil_hdot_nd(u: torch.Tensor, stencil_fn: StencilFn, mesh,
                    axes: Axes, width: int, periodic: bool = False,
                    subdomains=2, weights=None) -> torch.Tensor:
    """N-D interior/boundary over-decomposition (paper Code 4): the
    exchanges leave first, the interior chunk grid (which depends only on
    `u`) runs while they fly, and the 2·N face tasks consume the halos.
    Numerics identical to the two-phase schedule."""
    return stencil_with_exchange_nd(
        u, _start_halo_nd(u, mesh, axes, width, periodic), stencil_fn, width,
        tuple(d for _, d in axes), subdomains, weights)


def stencil_apply_nd(u: torch.Tensor, stencil_fn: StencilFn, mesh,
                     axes: Axes, width: int, periodic: bool = False,
                     mode: str = "hdot", subdomains=2,
                     weights=None) -> torch.Tensor:
    if mode == "hdot":
        return stencil_hdot_nd(u, stencil_fn, mesh, axes, width, periodic,
                               subdomains, weights)
    if mode in ("none", "two_phase"):
        return stencil_two_phase_nd(u, stencil_fn, mesh, axes, width,
                                    periodic)
    raise ValueError(f"unknown overlap mode {mode!r}")


def _stack_outs(outs, u: torch.Tensor) -> torch.Tensor:
    if not outs:  # steps == 0: a length-0 history, as lax.scan gives
        return torch.empty((0,), dtype=u.dtype, device=u.device)
    return torch.stack(outs)


def halo_scan_nd(u: torch.Tensor, stencil_fn: StencilFn, mesh, axes: Axes,
                 width: int, steps: int, periodic: bool = False,
                 mode: str = "hdot", subdomains=2,
                 step_out_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor]] = None,
                 weights=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Double-buffered multi-step stencil driver on an N-D process mesh.

    In hdot mode each step (1) waits on its halos and finishes its 2·N
    boundary faces — the only halo consumers; (2) IMMEDIATELY issues every
    axis's exchange for step k+1, its edges stitched from the face outputs
    alone; (3) only then computes the interior chunk grid. The last step is
    peeled: it computes its interior while its halos fly, then consumes them
    and sends nothing.

    `step_out_fn(u_new, u_old)` optionally produces a per-step output (e.g.
    a residual) that stays on the device; the results are stacked at the
    end and returned as the second element (None without it). Numerics
    equal `steps` iterated :func:`stencil_apply_nd` calls. `weights`
    (per-dim chunk extents from :func:`repro_torch.core.domain.interior_cuts`)
    cuts the interior grid unevenly; the faces and messages stay the same.

    A degenerate block (an extent < 4·width), ``steps < 1`` or two_phase
    mode runs the plain exchange -> compute loop."""
    axes = tuple((a, d) for a, d in axes)
    dims = tuple(d for _, d in axes)
    w = width
    ext = tuple(u.shape[d] for d in dims)
    outs = []
    if mode != "hdot" or any(n < 4 * w for n in ext) or steps < 1:
        for _ in range(steps):
            u_new = stencil_apply_nd(u, stencil_fn, mesh, axes, w, periodic,
                                     mode, subdomains, weights)
            if step_out_fn is not None:
                outs.append(step_out_fn(u_new, u))
            u = u_new
        return u, _stack_outs(outs, u) if step_out_fn is not None else None

    subdomains = _norm_subn(subdomains, len(dims))

    def exchange_from_faces(faces) -> List[HaloExchange]:
        # The new block's axis-k edges, stitched from face outputs alone:
        # axis k's edge spans the full extent of every other dim, the earlier
        # axes' faces contribute their first / last `w` cells along dim k
        # (faces of LATER axes never reach the edge region).
        pending = []
        for k, (a, dk) in enumerate(axes):
            lo_e, hi_e = faces[k]
            nk = ext[k]
            for j in reversed(range(k)):
                lo_j, hi_j = faces[j]
                lo_e = torch.cat(
                    [_sl(lo_j, dk, 0, w), lo_e, _sl(hi_j, dk, 0, w)],
                    dim=dims[j])
                hi_e = torch.cat(
                    [_sl(lo_j, dk, nk - w, nk), hi_e,
                     _sl(hi_j, dk, nk - w, nk)], dim=dims[j])
            pending.append(start_exchange(lo_e, hi_e, mesh, a, periodic))
        return pending

    pending = _start_halo_nd(u, mesh, axes, w, periodic)  # pipeline fill
    for step in range(steps):
        if step == steps - 1:
            # peeled drain: the last step consumes its halos, sends nothing
            u_new = stencil_with_exchange_nd(u, pending, stencil_fn, w, dims,
                                             subdomains, weights)
        else:
            halos = [p.wait() for p in pending]
            faces = _faces_nd(u, halos, stencil_fn, w, dims)
            pending = exchange_from_faces(faces)
            interior = _interior_chunks_nd(u, stencil_fn, w, dims,
                                           subdomains, weights)
            u_new = _assemble_nd(faces, interior, dims)
        if step_out_fn is not None:
            outs.append(step_out_fn(u_new, u))
        u = u_new
    return u, _stack_outs(outs, u) if step_out_fn is not None else None


def multi_dim_stencil(u: torch.Tensor,
                      per_dim_fn: Callable[..., torch.Tensor], mesh,
                      decomp: Sequence[Tuple[int, Optional[str]]],
                      width: int, periodic: bool = False,
                      mode: str = "hdot") -> torch.Tensor:
    """Apply a direction-split stencil along several dims and sum the
    directions in `decomp` order (the CREAMS pattern: euler_LLF_x/y/z are
    separate per-direction stencils whose results add). `decomp` lists
    ``(dim, mesh_axis_or_None)``; ``per_dim_fn(padded, dim=d)`` consumes a
    block padded by `width` along `d` alone. An unsharded dim is padded
    locally (periodic: the block's own far edges; else zeros); a sharded one
    runs :func:`stencil_apply_nd` on its axis with 4 interior chunks. `mesh`
    may be None when no dim is sharded."""
    total = None
    for dim, axis_name in decomp:
        fn = functools.partial(per_dim_fn, dim=dim)
        if axis_name is None:
            if periodic:
                padded = torch.cat([_edge(u, dim, "hi", width), u,
                                    _edge(u, dim, "lo", width)], dim=dim)
            else:
                pads = [(0, 0)] * u.dim()
                pads[dim] = (width, width)
                padded = _pad(u, pads)
            out = fn(padded)
        else:
            out = stencil_apply_nd(u, fn, mesh, ((axis_name, dim),), width,
                                   periodic, mode, (4,))
        total = out if total is None else total + out
    return total
