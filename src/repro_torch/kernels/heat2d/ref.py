"""Plain PyTorch version of the blocked red-black Gauss-Seidel tile sweep.

The semantics are those of the Pallas kernel
(``repro.kernels.heat2d.heat2d.heat2d_sweep_pallas``): Gauss-Seidel *within*
a (tx, ty) tile in red-black order — colour by TILE-LOCAL parity
``(ii + jj) % 2`` — and Jacobi *across* tiles: a neighbour in another tile,
or past the block edge (the caller's halo ring, else zero), is read from the
INPUT and stays frozen for all sweeps. The sum is ``((N + S) + W) + E`` in
float32, times 0.25; bf16 input is computed in float32 and rounded once at
the end.

All tiles go at once: the block is viewed as (gx, tx, gy, ty) with four
frozen strips, so a 16384^2 grid is a handful of whole-grid tensor ops per
half-sweep rather than a Python loop over 4096 tiles. The CPU path of
:func:`repro_torch.kernels.heat2d.ops.heat2d_sweep` and the card's oracle
for the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def heat2d_sweep_blocked(u: torch.Tensor, tile: Sequence[int],
                         sweeps: int = 1,
                         halo: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """`sweeps` red-black passes over every (tx, ty) tile of the (nx, ny)
    block `u`; `tile` must divide the block (the wrapper clamps and checks).
    `halo=(north, south, west, east)` of shapes (1, ny), (1, ny), (nx, 1),
    (nx, 1) is the block's outer ghost ring; None means zeros."""
    nx, ny = u.shape
    tx, ty = tile
    gx, gy = nx // tx, ny // ty
    f = u.to(torch.float32)
    if halo is None:
        hn = hs = f.new_zeros((ny,))
        hw = he = f.new_zeros((nx,))
    else:
        hn, hs, hw, he = (h.to(device=u.device, dtype=torch.float32)
                          .reshape(-1) for h in halo)
    v = f.reshape(gx, tx, gy, ty)
    # frozen strips, from the input: the row above / below each tile, the
    # column left / right of it; the block's own ring at the edges
    north = torch.cat([hn.reshape(1, 1, gy, ty), v[:-1, -1:]], dim=0)
    south = torch.cat([v[1:, :1], hs.reshape(1, 1, gy, ty)], dim=0)
    west = torch.cat([hw.reshape(gx, tx, 1, 1), v[:, :, :-1, -1:]], dim=2)
    east = torch.cat([v[:, :, 1:, :1], he.reshape(gx, tx, 1, 1)], dim=2)

    ii = torch.arange(tx, device=u.device).reshape(1, tx, 1, 1)
    jj = torch.arange(ty, device=u.device).reshape(1, 1, 1, ty)
    red = (ii + jj) % 2 == 0
    black = ~red

    s = v
    for _ in range(sweeps):
        for colour in (red, black):
            nb = torch.cat([north, s[:, :-1]], dim=1)          # N
            nb += torch.cat([s[:, 1:], south], dim=1)          # + S
            nb += torch.cat([west, s[:, :, :, :-1]], dim=3)    # + W
            nb += torch.cat([s[:, :, :, 1:], east], dim=3)     # + E
            nb *= 0.25
            s = torch.where(colour, nb, s)
    return s.reshape(nx, ny).to(u.dtype)


def heat2d_sweep_ref(padded: torch.Tensor, sweeps: int = 1) -> torch.Tensor:
    """One tile: `padded` is an (n+2, m+2) block whose ring is the frozen
    halo; returns the updated (n, m) interior (corners are never read)."""
    u = padded[1:-1, 1:-1]
    halo = (padded[:1, 1:-1], padded[-1:, 1:-1],
            padded[1:-1, :1], padded[1:-1, -1:])
    return heat2d_sweep_blocked(u, tuple(u.shape), sweeps, halo)
