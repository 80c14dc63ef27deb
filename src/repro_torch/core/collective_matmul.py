"""Collective matmuls: the HDOT subdomain idea applied to tensor parallelism.

The port of ``repro/core/collective_matmul.py`` on ``torch.distributed``
ranks. A Megatron/SP layer computes  y = all_gather(x) @ W  and
z = reduce_scatter(h @ V). The ``two_phase`` schedule runs the whole
collective, then the whole matmul (the paper's serial comm/compute phases).
The ``hdot`` schedule over-decomposes the matmul into per-shard chunk tasks
that ride a ring of point-to-point messages to the axis's periodic
neighbours: chunk k is computed while chunk k+1 is in flight.

Where the JAX package leaves the overlap to XLA's scheduler, here it is in
the program: each step of a ring first issues the next hop (one
``dist.batch_isend_irecv`` carrying every piece, forward and backward ring
alike, each piece with its own tag), then computes this step's piece
matmuls, then waits. On CUDA the NCCL messages run on their own stream
while the piece matmuls run on the compute stream.

Conventions (per rank, mesh axis `axis_name` of size P, as the JAX
package's docstring gives them inside ``shard_map``):

  ag_matmul:  x_local (S/P, M), w_local (M, N/P)  ->  y_local (S, N/P)
  matmul_rs:  h_local (S, N/P), v_local (N/P, M)  ->  z_local (S/P, M)

Block r of the gathered rows belongs to the rank at coordinate r of the
axis. The rings reassociate the reduce-scatter's sum (the JAX order:
``received accumulator + this rank's part``, hop by hop), so hdot equals
two_phase up to floating-point rounding. Nothing here is differentiated
(nor is it in the JAX package).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def _ring_pieces(s_loc: int, bidirectional: bool, chunks) -> list:
    """Chunk-granularity knob: the independent ring 'tasks' the local rows
    are split into, as [(start, stop, backward), ...]. Defaults to 2 pieces
    (one per direction) for bidirectional rings; even pieces ride the forward
    ring, odd pieces the backward ring. Pieces may be uneven (odd/prime s_loc
    still rides both directions); every piece keeps its own static shape."""
    c = chunks if chunks is not None else (2 if bidirectional else 1)
    c = max(1, min(c, s_loc)) if s_loc else 1
    bounds = [(s_loc * i) // c for i in range(c + 1)]
    return [(a, b, (i % 2 == 1) and bidirectional)
            for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]


def _axis(mesh, axis_name: str):
    """(size, this rank's coordinate) of `axis_name`."""
    return (mesh.shape[axis_name],
            mesh.coords[mesh.axis_index(axis_name)])


def _start_hop(pieces: List[torch.Tensor], backward: List[bool], mesh,
               axis_name: str):
    """Send every piece one hop along its ring (forward pieces to the next
    rank, backward ones to the previous) and return (the receive buffers,
    the works) at once. All sends are posted before all receives, each in
    piece order, on every rank: on an axis of 2 both rings join the same
    two ranks, and NCCL matches one peer's messages in posting order (gloo
    by the tags)."""
    prev, nxt = mesh.neighbors(axis_name, periodic=True)
    recv = [torch.empty_like(p) for p in pieces]
    ops = [dist.P2POp(dist.isend, p, prev if bw else nxt, tag=i)
           for i, (p, bw) in enumerate(zip(pieces, backward))]
    ops += [dist.P2POp(dist.irecv, r, nxt if bw else prev, tag=i)
            for i, (r, bw) in enumerate(zip(recv, backward))]
    return recv, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _check_divides(s: int, n: int, axis_name: str) -> None:
    if s % n != 0:
        raise ValueError(
            f"gathered dim {s} must divide evenly over the {n} devices of "
            f"axis {axis_name!r} for the ring schedule (got remainder "
            f"{s % n})")


# ------------------------------------------------------------------ two-phase
def ag_matmul_two_phase(x: torch.Tensor, w: torch.Tensor, mesh,
                        axis_name: str) -> torch.Tensor:
    n, _ = _axis(mesh, axis_name)
    if n == 1:
        return x @ w
    xg = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                     device=x.device)
    dist.all_gather_into_tensor(xg, x.contiguous(),
                                group=mesh.axes_group((axis_name,)))
    return xg @ w


def matmul_rs_two_phase(h: torch.Tensor, v: torch.Tensor, mesh,
                        axis_name: str) -> torch.Tensor:
    n, _ = _axis(mesh, axis_name)
    z = h @ v                                             # (S, M) partial
    if n == 1:
        return z
    _check_divides(z.shape[0], n, axis_name)
    out = torch.empty((z.shape[0] // n,) + tuple(z.shape[1:]), dtype=z.dtype,
                      device=z.device)
    dist.reduce_scatter_tensor(out, z, group=mesh.axes_group((axis_name,)))
    return out


# ----------------------------------------------------------------------- HDOT
def ag_matmul_hdot(x: torch.Tensor, w: torch.Tensor, mesh, axis_name: str,
                   chunks: Optional[int] = None) -> torch.Tensor:
    """All-gather matmul as a ring of chunk tasks.

    The local rows are split into `chunks` pieces (default 2), each
    circulating its own ring: even pieces forward, odd pieces backward
    (``chunks=1`` is a one-direction ring). Step k computes the row block
    owned by rank (idx - k) [resp. (idx + k) on the backward ring], writing
    each piece's product straight into its rows of the output, after step
    k+1's hop has been issued."""
    n, idx = _axis(mesh, axis_name)
    if n == 1:
        return x @ w
    s_loc = x.shape[0]
    out = torch.empty((n * s_loc, w.shape[1]), dtype=x.dtype, device=x.device)
    pieces = _ring_pieces(s_loc, True, chunks)
    backward = [bw for _, _, bw in pieces]
    cur = [x[a:b].contiguous() for a, b, _ in pieces]
    for k in range(n):
        hop = (_start_hop(cur, backward, mesh, axis_name) if k != n - 1
               else None)
        for c_i, (a, b, bw) in enumerate(pieces):
            src = (idx + k) % n if bw else (idx - k) % n
            torch.mm(cur[c_i], w, out=out[src * s_loc + a:src * s_loc + b])
        if hop is not None:
            cur, works = hop
            _wait(works)
    return out


def matmul_rs_hdot(h: torch.Tensor, v: torch.Tensor, mesh, axis_name: str,
                   chunks: Optional[int] = None) -> torch.Tensor:
    """Reduce-scatter matmul as `chunks` concurrent accumulator rings.

    The output rows are split into `chunks` pieces (default 2); piece c's
    accumulator rides its own ring (even pieces forward, odd pieces
    backward), and at step k rank i folds in its contribution for row block
    (i -/+ k+1) mod n: the accumulators of step k-1 leave first, step k's
    piece matmuls run while they travel, and the received accumulator plus
    the new part is the next one."""
    n, idx = _axis(mesh, axis_name)
    if n == 1:
        return h @ v
    s = h.shape[0]
    _check_divides(s, n, axis_name)
    s_loc = s // n
    pieces = _ring_pieces(s_loc, True, chunks)
    backward = [bw for _, _, bw in pieces]

    def parts(k):
        out = []
        for a0, a1, bw in pieces:
            b = (idx + k + 1) % n if bw else (idx - k - 1) % n
            out.append(h[b * s_loc + a0:b * s_loc + a1] @ v)
        return out

    accs = parts(0)
    for k in range(1, n):
        recv, works = _start_hop(accs, backward, mesh, axis_name)
        new = parts(k)
        _wait(works)
        accs = [r + p for r, p in zip(recv, new)]
    # at k = n-1 the forward chain lands on b = (i - n) % n == i and the
    # backward chain on (i + n) % n == i: every accumulator holds the full
    # sum for rank i's piece
    return torch.cat(accs, dim=0)


def ring_permute_count(s_loc: int, n: int, bidirectional: bool = True,
                       chunks: Optional[int] = None) -> int:
    """Point-to-point sends one hdot ring issues: pieces x (n - 1), both
    directions (the JAX package's ppermutes)."""
    if n == 1:
        return 0
    return len(_ring_pieces(s_loc, bidirectional, chunks)) * (n - 1)


# ---------------------------------------------------------------- dispatchers
MODES = ("hdot", "two_phase")


def _check_mode(mode: str) -> None:
    """The JAX package runs every mode but "hdot" as two_phase; the port
    raises for a mode it does not know, as it does elsewhere."""
    if mode not in MODES:
        raise ValueError(f"unknown collective-matmul mode {mode!r}; "
                         f"expected one of {MODES}")


def ag_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis_name: str,
              mode: str = "hdot", chunks: Optional[int] = None
              ) -> torch.Tensor:
    _check_mode(mode)
    if mode == "hdot":
        return ag_matmul_hdot(x, w, mesh, axis_name, chunks=chunks)
    return ag_matmul_two_phase(x, w, mesh, axis_name)


def matmul_rs(h: torch.Tensor, v: torch.Tensor, mesh, axis_name: str,
              mode: str = "hdot", chunks: Optional[int] = None
              ) -> torch.Tensor:
    _check_mode(mode)
    if mode == "hdot":
        return matmul_rs_hdot(h, v, mesh, axis_name, chunks=chunks)
    return matmul_rs_two_phase(h, v, mesh, axis_name)
