"""Time variants of the LRU scan, the Heat2D tile sweep and the bf16 SSD
backward (``ssd_chunk_bwd``) CUDA kernels side by side on one card, at the
shapes of the main paths:

    PYTHONPATH=src python3 tools/kernel_variants.py \
        [--kernel lru|heat2d|ssd_bwd|all]

A variant is a copy of the committed source with other values of its
constants (``kSteps``, ``kWarps``, ``kMaxCluster``, ``kMinBlocks`` in
``lru_scan.cu``; ``kBandBudget``, which sets the blocks a tile is split
over, and ``kThreads`` in ``heat2d.cu``; ``kProd``, the producer's threads,
and ``kStages`` of the backward's tensor-core kernel in ``ssd_scan.cu``),
written under ``build/exp/``; the committed source and every copy are
built at once (one nvcc each). Each variant is first checked against the
plain version (LRU within the JAX suite's 1e-5, Heat2D f32 bit for bit)
or, for the SSD backward, against the committed source (bit for bit: the
constants do not change the arithmetic), then timed with CUDA events around
back-to-back calls of its C function, with arguments prepared once into
outputs made once (the wrapper's host work is not timed), in the order
A B C ... C B A; a variant's time is the mean of its two turns. Prints one
JSON line per built variant (ptxas's registers and spills) and per case and
variant, and the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.heat2d import ops as heat_ops
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

EXP_DIR = _build.REPO_ROOT / "build" / "exp"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, as chip_smoke.py

# name -> constants changed from the committed source ({}: the source)
LRU_VARIANTS = {
    "committed": {},
    "steps8": {"kSteps": 8, "kMinBlocks": 4},
    "warps16": {"kWarps": 16, "kMinBlocks": 1},
    "cluster4": {"kMaxCluster": 4},
}
LRU_SHAPES = [(1, 2048, 2560), (8, 1000, 2560)]
HEAT_VARIANTS = {
    "committed": {},
    "cluster2": {"kBandBudget": 140000},
    "cluster8": {"kBandBudget": 36000},
    "threads128": {"kThreads": 128},
}
SSD_BWD_VARIANTS = {
    "committed": {},
    "producer64": {"kProd": 64},
    "stages2": {"kStages": 2},
}
# Mamba-2 780M's training shape (chip_smoke.SSD_BWD_SHAPE): b, l, h, p, n,
# chunk
SSD_BWD_SHAPE = (8, 2048, 48, 64, 128, 256)
HEAT_CASES = [((16384, 16384), (256, 256), 0),
              ((16384, 16384), (256, 256), 1),
              ((16384, 16384), (256, 256), 4),
              ((16384, 16384), (128, 64), 1)]


def variant_source(source: Path, name: str, consts: dict) -> Path:
    """The committed source, or a copy under build/exp/ with `consts`."""
    if not consts:
        return source
    text = source.read_text()
    for const, value in consts.items():
        text, n = re.subn(rf"(constexpr\s+\w+\s+{const}\s*=\s*)[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{source.name}: {const} defined {n} times")
    path = EXP_DIR / f"{source.stem}_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def build_all(source: Path, variants: dict, kernel: str, emit) -> dict:
    """Builds every variant at once; returns {name: CDLL}."""
    paths = {n: variant_source(source, n, c) for n, c in variants.items()}
    logs = _build.build(paths.values())
    for name, path in paths.items():
        log = logs.get(path, (0.0, "(built earlier)"))[1]
        emit({"kernel": kernel, "variant": name, "consts": variants[name],
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})
    return {n: ctypes.CDLL(str(_build.library_path(p)))
            for n, p in paths.items()}


def time_ms(fn, reps=20, batches=3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def turns(fns) -> list:
    """A B C ... C B A: the mean of each callable's two turns."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    got = [[] for _ in fns]
    for i in order:
        got[i].append(time_ms(fns[i]))
    return [sum(t) / len(t) for t in got]


def checked(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def lru(dev, card, emit):
    libs = build_all(lru_ops.SOURCE, LRU_VARIANTS, "lru_scan", emit)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, l, w in LRU_SHAPES:
        a = 0.5 + 0.49 * torch.rand((b, l, w), generator=gen, device=dev)
        x = torch.randn((b, l, w), generator=gen, device=dev)
        h0 = torch.randn((b, w), generator=gen, device=dev)
        want, want_last = lru_ops.lru_scan(a, x, h0, "plain")
        fns, plans = [], []
        for name, lib in libs.items():
            fn = lib.lru_scan_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            h = torch.empty_like(x)
            h_last = torch.empty_like(h0)
            args = (a.data_ptr(), x.data_ptr(), h0.data_ptr(), h.data_ptr(),
                    h_last.data_ptr(), b, l, w, 0, 0, stream)
            checked(fn(*args), f"lru_scan {name}")
            torch.cuda.synchronize()
            if not (((h - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()
                    and ((h_last - want_last).abs()
                         <= 1e-5 + 1e-5 * want_last.abs()).all()):
                raise RuntimeError(f"lru_scan {name} off plain at {(b, l, w)}")
            plan = (ctypes.c_int * 3)()
            lib.lru_scan_plan(l, plan)
            plans.append(list(plan))
            fns.append(lambda fn=fn, args=args, keep=(h, h_last):
                       checked(fn(*args), "lru_scan"))
        nbytes = 3 * a.numel() * 4 + 2 * b * w * 4
        for (name, consts), plan, ms in zip(LRU_VARIANTS.items(), plans,
                                            turns(fns)):
            emit({"kernel": "lru_scan", "shape": [b, l, w], "variant": name,
                  "consts": consts, "cluster_warps_steps": plan,
                  "launch_ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "gpu": card})
        del a, x, h0, want, want_last, fns


def heat2d(dev, card, emit):
    libs = build_all(heat_ops.SOURCE, HEAT_VARIANTS, "heat2d_sweep", emit)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, tile, sweeps in HEAT_CASES:
        u = torch.randn(shape, generator=gen, device=dev)
        want = heat_ops.heat2d_sweep(u, tile, sweeps, "plain")
        out = torch.empty_like(u)
        fns, plans = [], []
        for name, lib in libs.items():
            fn = lib.heat2d_sweep
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            smem = ctypes.c_longlong(0)
            nc = lib.heat2d_plan(tile[0], tile[1], ctypes.byref(smem))
            if nc == 0:
                raise RuntimeError(f"heat2d {name}: tile {tile} is global")
            plans.append([nc, smem.value])
            args = (u.data_ptr(), out.data_ptr(), None, None, None, None,
                    None, *shape, *tile, sweeps, 0, stream)
            checked(fn(*args), f"heat2d {name}")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"heat2d {name} != plain at {tile}")
            fns.append(lambda fn=fn, args=args: checked(fn(*args), "heat2d"))
        bound = 2 * u.numel() * 4 / HBM_BYTES_PER_S * 1e3
        for (name, consts), plan, ms in zip(HEAT_VARIANTS.items(), plans,
                                            turns(fns)):
            emit({"kernel": "heat2d_sweep", "shape": list(shape),
                  "tile": list(tile), "sweeps": sweeps, "variant": name,
                  "consts": consts, "cluster_smem_bytes": plan,
                  "launch_ms": ms, "bound_ms": bound, "gpu": card})
        del u, want, out, fns


def ssd_bwd(dev, card, emit):
    libs = build_all(ssd_ops.SOURCE, SSD_BWD_VARIANTS, "ssd_chunk_bwd", emit)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, h, p, n, chunk = SSD_BWD_SHAPE
    c = l // chunk
    bf = torch.bfloat16
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev))
    A = -torch.exp(0.2 * torch.randn((h,), generator=gen, device=dev))
    B, C = (torch.randn((b, l, n), generator=gen, device=dev).to(bf)
            for _ in range(2))
    cots = (torch.randn((b, c, chunk, h, p), generator=gen, device=dev),
            torch.randn((b, c, h, n, p), generator=gen, device=dev),
            torch.randn((b, c, chunk, h), generator=gen, device=dev))
    fns, first = [], None
    for name, lib in libs.items():
        fn = lib.ssd_chunk_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
        lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 5
        work = torch.empty(lib.ssd_chunk_bwd_workspace(b, c, chunk, h, n),
                           dtype=torch.uint8, device=dev)
        outs = [torch.empty_like(t) for t in (x, dt, A, B, C)]
        args = (*(t.data_ptr() for t in (x, dt, A, B, C, *cots)),
                *(o.data_ptr() for o in outs), work.data_ptr(), b, c, chunk,
                h, p, n, 1, stream)
        checked(fn(*args), f"ssd_chunk_bwd {name}")
        torch.cuda.synchronize()
        if first is None:
            first = [o.clone() for o in outs]
        elif not all(torch.equal(o, f) for o, f in zip(outs, first)):
            raise RuntimeError(f"ssd_chunk_bwd {name} != the committed one")
        fns.append(lambda fn=fn, args=args, keep=(work, outs):
                   checked(fn(*args), "ssd_chunk_bwd"))
    item = x.element_size()
    nbytes = (2 * (x.numel() + B.numel() + C.numel()) * item
              + 4 * (2 * dt.numel() + 2 * h + sum(t.numel() for t in cots)))
    for (name, consts), ms in zip(SSD_BWD_VARIANTS.items(), turns(fns)):
        emit({"kernel": "ssd_chunk_bwd", "shape": [b, l, h, p, n],
              "chunk": chunk, "dtype": "bf16", "variant": name,
              "consts": consts, "launch_ms": ms,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "gpu": card})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=["lru", "heat2d", "ssd_bwd", "all"],
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def emit(obj):
        print(json.dumps(obj), flush=True)

    emit({"gpu": card})
    if args.kernel in ("lru", "all"):
        lru(dev, card, emit)
    if args.kernel in ("heat2d", "all"):
        heat2d(dev, card, emit)
    if args.kernel in ("ssd_bwd", "all"):
        ssd_bwd(dev, card, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
