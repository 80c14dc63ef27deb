"""A/B of the SSD backward kernel (``ssd_chunk_bwd``) of two copies of
``ssd_scan.cu`` on one card, in one process: the repository's source
against another copy (say, an earlier version kept under ``build/exp/``),
at Mamba-2 780M's training shape (``chip_smoke.SSD_BWD_SHAPE``), bf16 and
f32. Both are checked against the plain backward (autograd of the plain
version) and against each other (largest difference over each gradient's
largest magnitude, and whether each gradient is bit-equal); the new one
is called twice for bit-equality; CUDA-event times alternate old, new,
new, old, old, new; then one traced call of the new one gives its
kernels' device times. One JSON line per dtype.

    git show <commit>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu \
        > build/exp/ssd_scan_old.cu
    PYTHONPATH=src python3 tools/ssd_bwd_ab.py build/exp/ssd_scan_old.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402


def other_library(path: Path):
    lib = _build.load(path)
    lib.ssd_chunk_bwd.restype = ctypes.c_int
    lib.ssd_chunk_bwd.argtypes = [ctypes.c_void_p] * 14 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
    lib.ssd_chunk_bwd_workspace.argtypes = [ctypes.c_int] * 5
    return lib


def compare(old, dtype, dev, card) -> dict:
    b, l, h, p, n, chunk = cs.SSD_BWD_SHAPE
    c = l // chunk
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((b, l, h, p), generator=g, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=g, device=dev))
    A = -torch.exp(0.2 * torch.randn((h,), generator=g, device=dev))
    B = torch.randn((b, l, n), generator=g, device=dev).to(dtype)
    C = torch.randn((b, l, n), generator=g, device=dev).to(dtype)
    dy = torch.randn((b, c, chunk, h, p), generator=g, device=dev)
    dst = torch.randn((b, c, h, n, p), generator=g, device=dev)
    ddi = torch.randn((b, c, chunk, h), generator=g, device=dev)
    work = torch.empty(old.ssd_chunk_bwd_workspace(b, c, chunk, h, n),
                       dtype=torch.uint8, device=dev)
    outs = [torch.empty_like(t) for t in (x, dt, A, B, C)]

    def run_old():
        err = old.ssd_chunk_bwd(
            *(t.data_ptr() for t in (x, dt, A, B, C, dy, dst, ddi)),
            *(o.data_ptr() for o in outs), work.data_ptr(), b, c, chunk, h,
            p, n, ops._DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other source's launch failed: {err}")
        return outs

    def run_new():
        return ops._launch_bwd(x, dt, A, B, C, chunk, dy, dst, ddi)

    new1 = [t.clone() for t in run_new()]
    new2 = run_new()
    old1 = [t.clone() for t in run_old()]
    parts = (x.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h), A,
             B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n))
    want = ref.ssd_chunk_terms_vjp_ref(*parts, dy, dst.transpose(-1, -2),
                                       ddi)
    torch.cuda.synchronize()
    names = ("dx", "ddt", "dA", "dB", "dC")

    def shaped(ts):
        return [t.reshape(w.shape) for t, w in zip(ts, want)]

    row = {"dtype": str(dtype).split(".")[-1], "gpu": card,
           "new_vs_plain": cs.rel_errs(names, shaped(new1), want),
           "old_vs_plain": cs.rel_errs(names, shaped(old1), want),
           "new_vs_old": cs.rel_errs(names, new1, old1),
           "new_equals_old": {n: torch.equal(a, b_)
                              for n, a, b_ in zip(names, new1, old1)},
           "new_bit_equal_twice": all(torch.equal(a, b_)
                                      for a, b_ in zip(new1, new2))}
    times = {"old": [], "new": []}
    for side in ("old", "new", "new", "old", "old", "new"):
        times[side].append(cs.time_ms(run_old if side == "old" else run_new))
    row["ms"] = times
    row["new_kernels"] = cs.traced_families(
        run_new, cs.recurrent_family)["port_kernels"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other ssd_scan.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.gpu_line()
    _build.build([ops.SOURCE, args.other])
    old = other_library(args.other)
    for dtype in (torch.bfloat16, torch.float32):
        print(json.dumps(compare(old, dtype, dev, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
