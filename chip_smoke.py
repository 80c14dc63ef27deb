#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path — Heat2D under the HDOT schedule — at a
16384 x 16384 float32 grid (1 GiB a buffer) through the entry points a user
calls, and holds the hand-written CUDA kernel of that path against its plain
PyTorch version:

  1. build    nvcc builds every kernel of the path from the checkout's
              sources; prints the build seconds and the card's name and
              power limit as nvidia-smi gives them.
  2. kernel   heat2d_sweep's CUDA kernel against its plain version on the
              same inputs: f32 tile (256, 256) with sweeps 1 and 4, tile
              (128, 64) with a random halo ring, and bf16. f32 must be
              bit-equal (same IEEE operations in the same order, no FMA);
              bf16 within one bf16 ulp after the cast. Kernel and plain
              times are CUDA-event medians of 10 runs after warm-up;
              bound_ms is the least time for the bytes the sweep must move.
  3-5. main   launch counts set to 0, then: heat2d_solve for 100 iterations
              on a (1,) slab mesh and a (1, 1) grid mesh in both schedules
              (hdot must equal two_phase exactly, the residual must not
              rise); heat2d_sweep_sharded on the (1, 1) mesh (must equal
              heat2d_sweep with a zero ring, and launch the kernel);
              heat2d_solve_rebalanced with a skewed synthetic chunk cost
              (must re-cut, and equal heat2d_solve run segment by segment on
              the same cuts, bit for bit). Counts read right after.
  6. profile  a separate traced run of 5 solver steps per schedule on the
              (1, 1) mesh: device time by CUDA kernel and the device's idle
              share of the traced window.

Each phase prints one JSON line; then the nvidia-smi line, the kernels line
and, last, ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without CUDA, or without the repository beside it, the script
exits non-zero before printing any result.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
N = 16384                   # global grid edge: 16384^2 f32 = 1 GiB
ITERS = 100                 # heat2d_solve iterations per mode
PROFILE_ITERS = 5           # solver steps in each traced window
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/heat2d/csrc/heat2d.cu"
REPLACES = "src/repro/kernels/heat2d/heat2d.py:72"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of `fn` over `reps` runs after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sweep_bound_ms(nx: int, ny: int, itemsize: int, sweeps: int,
                   halo: bool):
    """Least time for one sweep call: read u once and write out once (plus
    the halo strips), against 5 f32 flops per cell per sweep."""
    nbytes = 2 * nx * ny * itemsize + (4 * (nx + ny) if halo else 0)
    ops = 5 * nx * ny * sweeps
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def profile_solve(solve, u0, mesh, mode: str, card: str) -> dict:
    """A separate traced run of PROFILE_ITERS solver steps on the (1, 1)
    mesh (the timed runs above are untraced): device time per CUDA kernel
    from torch.profiler, and the device's busy time against the wall clock
    of the traced window (which the tracing itself lengthens, so the idle
    share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    solve(u0, mesh, ("rows", "cols"), 1, mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(u0, mesh, ("rows", "cols"), PROFILE_ITERS, mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"phase": "profile", "mesh": "1x1", "mode": mode,
            "iters": PROFILE_ITERS, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": e.key[:100], "count": e.count,
                             "ms": dev_us(e) / 1e3} for e in top],
            "gpu": card}


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       (e - 8).to(torch.int32))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core.stencil import heat2d_init, heat2d_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels.heat2d import ops as heat_ops
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh
    from repro_torch.runtime.rebalance import heat2d_solve_rebalanced

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = gpu_line()

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    built = _build.build([heat_ops.SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for _, log in built.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": [KERNEL_SOURCE],
          "ptxas": ptxas, "gpu": card})

    # ------------------------------------------- 2. kernel vs plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((N, N), generator=gen, device=dev)
    ring = (torch.randn((1, N), generator=gen, device=dev),
            torch.randn((1, N), generator=gen, device=dev),
            torch.randn((N, 1), generator=gen, device=dev),
            torch.randn((N, 1), generator=gen, device=dev))
    cases = [("f32", (256, 256), 1, None), ("f32", (256, 256), 4, None),
             ("f32", (128, 64), 1, ring), ("bf16", (256, 256), 1, None)]
    kernel_rows = []
    for dtype_name, tile, sweeps, halo in cases:
        x = u if dtype_name == "f32" else u.to(torch.bfloat16)
        launched = heat_ops.heat2d_sweep.launches
        got = heat_ops.heat2d_sweep(x, tile, sweeps, "kernel", halo)
        want = heat_ops.heat2d_sweep(x, tile, sweeps, "plain", halo)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype_name == "f32":
            # same IEEE operations in the same order on both sides
            check(err == 0.0, f"f32 kernel != plain {tile} x{sweeps}: {err}")
        else:
            check(bool((diff <= bf16_ulp(want)).all()),
                  f"bf16 kernel off plain by more than one ulp: {err}")
        del got, want, diff
        k_ms = time_ms(lambda: heat_ops.heat2d_sweep(
            x, tile, sweeps, "kernel", halo))
        p_ms = time_ms(lambda: heat_ops.heat2d_sweep(
            x, tile, sweeps, "plain", halo))
        bound, bound_by = sweep_bound_ms(N, N, x.element_size(), sweeps,
                                         halo is not None)
        row = {"phase": "kernel", "dtype": dtype_name, "shape": [N, N],
               "tile": list(tile), "sweeps": sweeps,
               "halo": halo is not None, "max_abs_err": err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
               "bound_by": bound_by,
               "launches": heat_ops.heat2d_sweep.launches - launched,
               "gpu": card}
        emit(row)
        kernel_rows.append(row)
        del x
    # reference for the sharded sweep: the kernel with a zero ring
    zeros = (torch.zeros((1, N), device=dev), torch.zeros((1, N), device=dev),
             torch.zeros((N, 1), device=dev), torch.zeros((N, 1), device=dev))
    want_sharded = heat_ops.heat2d_sweep(u, (256, 256), 1, "kernel", zeros)
    check(torch.equal(want_sharded,
                      heat_ops.heat2d_sweep(u, (256, 256), 1, "plain")),
          "zero ring != no ring")

    # -------------------------------------------- 3-5. the main path, counted
    heat_ops.heat2d_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)

    u0 = heat2d_init(N, N, device=dev)
    meshes = [(make_mesh((1,), ("data",)), ("data",), "1"),
              (make_grid_mesh(1, 1), ("rows", "cols"), "1x1")]
    solved = {}
    for mesh, axes, label in meshes:
        for mode in ("two_phase", "hdot"):
            heat2d_solve(u0, mesh, axes, 2, mode)      # warm the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uf, res = heat2d_solve(u0, mesh, axes, ITERS, mode)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = res.cpu()
            check(tuple(uf.shape) == (N, N) and tuple(r.shape) == (ITERS,),
                  f"solve shapes {tuple(uf.shape)} {tuple(r.shape)}")
            check(bool(torch.isfinite(uf).all()), "non-finite grid")
            # Jacobi on Laplace is monotone; 1e-7 is the JAX suite's own
            # rounding slack (tests/test_stencil_apps.py)
            check(bool((r[1:] - r[:-1] <= 1e-7).all()) and r[-1] < r[0],
                  f"residual rose on {label} {mode}")
            solved[(label, mode)] = (uf, res)
            emit({"phase": "solve", "mesh": label, "mode": mode,
                  "shape": [N, N], "iters": ITERS, "seconds": dt,
                  "sweeps_per_s": ITERS / dt, "residual_first": float(r[0]),
                  "residual_last": float(r[-1]), "gpu": card})
        a, b = solved[(label, "two_phase")], solved[(label, "hdot")]
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"hdot != two_phase on mesh {label}")
    check(torch.equal(solved[("1", "hdot")][0], solved[("1x1", "hdot")][0]),
          "slab mesh != grid mesh")
    del solved

    grid = make_grid_mesh(1, 1)
    got = heat_ops.heat2d_sweep_sharded(u, grid, ("rows", "cols"),
                                        (256, 256), 1)
    torch.cuda.synchronize()
    sharded_ok = torch.equal(got, want_sharded)
    del got, want_sharded

    slab = make_mesh((1,), ("data",))
    reb_iters, every = 24, 8

    def skewed(idx, shape):  # chunk 0 along dim 0 costs 4x per cell
        return (4.0 if idx[0] == 0 else 1.0) * math.prod(shape) * 1e-9

    t0 = time.perf_counter()
    ur, rr, info = heat2d_solve_rebalanced(
        u0, slab, ("data",), reb_iters, "hdot", 4, rebalance_every=every,
        chunk_cost_fn=skewed)
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    launches = heat_ops.heat2d_sweep.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    check(sharded_ok, "heat2d_sweep_sharded != heat2d_sweep with zero ring")
    check(launches > 0, "the main path never launched the heat2d kernel")
    check(len(info["cut_history"]) > 1, "the skewed cost never re-cut")
    check(all(c in info["cut_history"] for c in info["segment_cuts"]),
          "a segment ran on a cut outside cut_history")
    x, parts = u0, []
    for cut in info["segment_cuts"]:
        x, r = heat2d_solve(x, slab, ("data",), every, "hdot", 4,
                            chunk_weights=cut)
        parts.append(r)
    check(torch.equal(x, ur) and torch.equal(torch.cat(parts), rr),
          "rebalanced != heat2d_solve segment by segment")
    emit({"phase": "sharded", "mesh": "1x1", "equal": sharded_ok,
          "launches": launches})
    emit({"phase": "rebalance", "iters": reb_iters, "every": every,
          "cut_history": info["cut_history"], "seconds": reb_s,
          "peak_mem_gib_main_path": peak_gib})

    # ------------------------------ 6. where a solve step goes (traced run)
    for mode in ("two_phase", "hdot"):
        emit(profile_solve(heat2d_solve, u0, grid, mode, card))

    # -------------------------------------------------------------- results
    main_row = kernel_rows[0]
    print(f"nvidia-smi: {card}", flush=True)
    emit({"kernels": [{
        "name": "heat2d_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
