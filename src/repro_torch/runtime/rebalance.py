"""Measured-cost dynamic re-partitioning on the HDOT schedule.

Two entry points live here:

* :func:`heat2d_solve_rebalanced` runs the Heat2D solver in segments; after
  each segment the per-chunk costs are folded into a
  :class:`repro_torch.core.cost.CostModel`, marginalized into per-dim
  per-cell profiles and the interior chunk grid is re-cut
  (:func:`repro_torch.core.domain.part_extents`). Where the JAX package
  recompiles its solver when the cut moves, the port just runs the next
  segment on the new cut ("re-cut"). The messages are untouched: the faces
  depend on the halo width alone, never on where the interior is cut.
* :func:`straggler_drill`, a LIVE multi-process drill: numpy-only Jacobi
  band workers behind pipes, one optionally slowed; the coordinator re-cuts
  the band decomposition from measured per-worker rates and (on worker
  death) reroutes bands via :func:`repro_torch.runtime.ft.reassign_host_shards`.

The module imports numpy and the port's pure-Python modules only; torch
is imported inside :func:`heat2d_solve_rebalanced`. The drill's spawned
workers import this module, and four workers of two runs must not each pay
for torch.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import time
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.domain import part_extents

if TYPE_CHECKING:
    import torch


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
    import torch

    from repro_torch.core.halo import _norm_subn
    from repro_torch.core.stencil import (_heat2d_cuts, _heat2d_run,
                                          local_block, normalize_mesh_axes)

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


# ======================================================= live straggler drill
def _drill_init(rows: int, cols: int) -> np.ndarray:
    """Hot square blob, Dirichlet-0 edges (numpy twin of heat2d_init)."""
    u = np.zeros((rows, cols), np.float32)
    w = max(1, rows // 8)
    u[rows // 2 - w:rows // 2 + w, cols // 2 - w:cols // 2 + w] = 1.0
    return u


def _jacobi_oracle(u: np.ndarray, steps: int) -> np.ndarray:
    for _ in range(steps):
        p = np.pad(u, 1)
        u = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    return u


def _drill_worker(conn, worker_id: int, seconds_per_cell: float) -> None:
    """Numpy-only Jacobi band worker (module level for mp 'spawn').

    Receives ``("step", band)`` where `band` is the owned rows plus one halo
    row on each side; replies ``(new_rows, elapsed_seconds)``. The synthetic
    per-cell cost is enforced by sleeping out the remainder of
    ``seconds_per_cell * cells``, a deterministic stand-in for a slow host
    (sleep dominates compute noise)."""
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            conn.close()
            return
        band = msg[1]
        t0 = time.perf_counter()
        p = np.pad(band, ((0, 0), (1, 1)))
        out = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1]
                      + p[1:-1, :-2] + p[1:-1, 2:])
        budget = seconds_per_cell * out.size
        time.sleep(max(0.0, budget - (time.perf_counter() - t0)))
        conn.send((out, time.perf_counter() - t0))


def straggler_drill(workers: int = 4, rows: int = 64, cols: int = 64,
                    steps: int = 24, warmup: int = 4,
                    rebalance_every: int = 4, slow_worker: int = 0,
                    slow_factor: float = 3.0,
                    seconds_per_cell: float = 8e-6,
                    dynamic: bool = True,
                    fail_worker: Optional[int] = None,
                    fail_at_step: Optional[int] = None,
                    alpha: float = 0.5) -> Dict:
    """Live dynamic-load-balance drill: `workers` processes each own one row
    band of a Jacobi grid; `slow_worker` runs `slow_factor`x slower per cell.

    Static mode keeps the uniform band cut for the whole run (every step
    waits for the straggler). Dynamic mode records each worker's measured
    per-cell rate into a :class:`CostModel` and re-cuts the band extents
    every `rebalance_every` steps: work migrates away from the straggler.

    If `fail_worker`/`fail_at_step` are set, that worker is terminated
    mid-run and its band is rerouted to a survivor via
    :func:`repro_torch.runtime.ft.reassign_host_shards` (any survivor can
    compute any band from the current grid).

    Returns throughput (`steps_per_s`, measured after `warmup` steps), the
    cut history, the final band extents, and `max_err` against a
    single-process oracle (the re-cut never changes the numerics)."""
    if not 0 < warmup < steps:
        raise ValueError(f"need 0 < warmup < steps, got {warmup}/{steps}")
    if not 0 <= slow_worker < workers:
        raise ValueError(f"slow_worker {slow_worker} out of range")
    if (fail_worker is None) != (fail_at_step is None):
        raise ValueError("fail_worker and fail_at_step go together")

    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for wid in range(workers):
        parent, child = ctx.Pipe()
        rate = seconds_per_cell * (slow_factor if wid == slow_worker else 1.0)
        p = ctx.Process(target=_drill_worker, args=(child, wid, rate),
                        daemon=True)
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)

    cost = CostModel(alpha=alpha)
    u = _drill_init(rows, cols)
    extents = part_extents(rows, workers, None)
    cut_history = [extents]
    # band -> computing worker; identity until a failure reroutes
    owner = {b: b for b in range(workers)}
    failed: List[int] = []
    t_measured = None
    try:
        for step in range(steps):
            if fail_at_step is not None and step == fail_at_step and not failed:
                from repro_torch.runtime.ft import reassign_host_shards

                procs[fail_worker].terminate()
                conns[fail_worker].close()
                failed.append(fail_worker)
                assignment = reassign_host_shards(workers, failed)
                owner = {b: s for s, bands in assignment.items()
                         for b in bands}
            if step == warmup:
                t_measured = time.perf_counter()

            ranges = _extents_to_ranges(extents)
            new_u = np.empty_like(u)
            # survivors run their own band in parallel; rerouted bands go out
            # in later waves (a survivor serves its extra bands sequentially)
            waves: Dict[int, List[int]] = {}
            for band, srv in owner.items():
                waves.setdefault(srv, []).append(band)
            depth = max(len(v) for v in waves.values())
            for wave in range(depth):
                sent = []
                for srv, bands in waves.items():
                    if wave >= len(bands):
                        continue
                    band = bands[wave]
                    a, b = ranges[band]
                    top = u[a - 1:a] if a > 0 else np.zeros((1, cols),
                                                            u.dtype)
                    bot = u[b:b + 1] if b < rows else np.zeros((1, cols),
                                                               u.dtype)
                    conns[srv].send(
                        ("step", np.concatenate([top, u[a:b], bot])))
                    sent.append((srv, band, a, b))
                for srv, band, a, b in sent:
                    out, elapsed = conns[srv].recv()
                    new_u[a:b] = out
                    cost.record((band,), elapsed, cells=(b - a) * cols)
            u = new_u

            recut = (dynamic and rebalance_every > 0
                     and (step + 1) % rebalance_every == 0
                     and step + 1 < steps)
            if recut:
                wts = cost.weights_along([ranges])
                new_extents = part_extents(rows, workers, wts[0])
                if new_extents != extents:
                    extents = new_extents
                    cut_history.append(extents)
        elapsed_measured = time.perf_counter() - t_measured
    finally:
        for c in conns:
            try:
                c.send(("stop",))
                c.close()
            except (OSError, BrokenPipeError):
                pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)

    oracle = _jacobi_oracle(_drill_init(rows, cols), steps)
    return {
        "steps_per_s": (steps - warmup) / elapsed_measured,
        "cut_history": cut_history,
        "extents": extents,
        "max_err": float(np.abs(u - oracle).max()),
        "failed": failed,
        "owner": owner,
        "rates": {b: cost.ema((b,)) for b in range(workers)},
    }


def straggler_drill_compare(**kw) -> Dict:
    """Run the drill static then dynamic with identical skew; returns both
    results plus ``speedup`` = dynamic / static steps-per-second."""
    static = straggler_drill(dynamic=False, **kw)
    dynamic = straggler_drill(dynamic=True, **kw)
    return {"static": static, "dynamic": dynamic,
            "speedup": dynamic["steps_per_s"] / static["steps_per_s"]}
