"""Measured-cost dynamic re-partitioning on the HDOT schedule.

:func:`heat2d_solve_rebalanced` runs the Heat2D solver in segments; after
each segment the per-chunk costs are folded into a
:class:`repro_torch.core.cost.CostModel`, marginalized into per-dim per-cell
profiles and the interior chunk grid is re-cut
(:func:`repro_torch.core.domain.part_extents`). Where the JAX package
recompiles its solver when the cut moves, the port just runs the next
segment on the new cut ("re-cut"). The messages are untouched: the faces
depend on the halo width alone, never on where the interior is cut.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost import CostModel
from repro_torch.core.domain import part_extents
from repro_torch.core.halo import _norm_subn
from repro_torch.core.stencil import (_heat2d_cuts, _heat2d_run,
                                      local_block, normalize_mesh_axes)


def _extents_to_ranges(extents: Sequence[int]) -> List[Tuple[int, int]]:
    """Chunk extents -> half-open (start, stop) ranges along one dim."""
    out, a = [], 0
    for e in extents:
        out.append((a, a + e))
        a += e
    return out


def heat2d_solve_rebalanced(u0: torch.Tensor, mesh, mesh_axes, iters: int,
                            mode: str = "hdot", subdomains=4,
                            rebalance_every: int = 8,
                            cost_model: Optional[CostModel] = None,
                            chunk_cost_fn: Optional[Callable] = None):
    """heat2d_solve with a measured-cost re-cut loop.

    Runs `iters` sweeps in segments of `rebalance_every` on this rank's
    block of the GLOBAL grid `u0`; after each segment the per-chunk costs
    are recorded, marginalized (:meth:`CostModel.weights_along`) and the
    interior chunk grid is re-cut. A cut changes the schedule, never the
    numbers.

    `chunk_cost_fn(chunk_index, chunk_shape) -> seconds` supplies per-chunk
    measurements (grid-index keyed, local-interior chunk shapes). Without it
    the cut stays static: whole-segment wall clock has no per-chunk
    resolution. `rebalance_every=0` runs one segment on the uniform cut.

    Returns ``(local block, residuals, info)`` with ``info["cut_history"]``
    the list of canonical cuts used (length 1 + number of re-cuts) — the
    same list the JAX package gives for the same costs — and
    ``info["segment_cuts"]`` the cut each segment ran on."""
    if rebalance_every < 0:
        raise ValueError(
            f"rebalance_every must be >= 0, got {rebalance_every}")
    axes = normalize_mesh_axes(mesh_axes, "heat2d_solve_rebalanced", (1, 2))
    cost = cost_model if cost_model is not None else CostModel()
    subs = _norm_subn(subdomains, len(axes))
    width = 1

    inner, grid = [], []
    for d, name in enumerate(axes):
        n_local = u0.shape[d] // mesh.shape[name]
        e = max(0, n_local - 2 * width)
        inner.append(e)
        grid.append(max(1, min(subs[d], e // (2 * width))))
    cuts = tuple(part_extents(e, k, None) for e, k in zip(inner, grid))

    u, residuals = local_block(u0, mesh, axes), []
    cut_history, segment_cuts = [cuts], []
    seg = rebalance_every if rebalance_every > 0 else iters
    done = 0
    while done < iters:
        n = min(seg, iters - done)
        run_cuts = _heat2d_cuts(u0.shape, mesh, axes, subs, cuts)
        u, r = _heat2d_run(u, mesh, axes, n, mode, subs, run_cuts)
        residuals.append(r)
        segment_cuts.append(cuts)
        done += n
        if done >= iters or rebalance_every <= 0:
            break

        if chunk_cost_fn is None:
            continue
        ranges = [_extents_to_ranges(c) for c in cuts]
        for idx in itertools.product(*[range(len(rg)) for rg in ranges]):
            shape = tuple(rg[i][1] - rg[i][0] for rg, i in zip(ranges, idx))
            cells = max(1, math.prod(shape))
            cost.record(idx, chunk_cost_fn(idx, shape), cells=cells)
        wts = cost.weights_along(ranges)
        new_cuts = tuple(part_extents(e, len(c), w)
                         for e, c, w in zip(inner, cuts, wts))
        if new_cuts != cuts:
            cuts = new_cuts
            cut_history.append(cuts)

    info = {"cut_history": cut_history, "recuts": len(cut_history) - 1,
            "segment_cuts": segment_cuts, "cost_model": cost}
    res = torch.cat(residuals) if residuals else torch.empty(
        (0,), dtype=u.dtype, device=u.device)
    return u, res, info
