"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``gpubench/`` and
the program (``src/repro_torch``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from the device trace of a few traced steps. Every run checks what its
timed path produced against the plain reference (``gpubench/check.py``)
and prints each number compared beside its limit, last on standard error
and last in the line. The run fails, printing no line, without a CUDA
card (or with fewer than the cell asks for), without the program, or when
a module of the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up counts from the process's start

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench import bench  # noqa: E402


def fail(msg: str, code: int = 1) -> None:
    print(f"gpubench: {msg}", file=sys.stderr)
    sys.exit(code)


def read_per_layer(cell, res, kind: str) -> dict:
    """Every per-layer metric of the cell whose reader found something in
    the trace (a reader that finds nothing returns None)."""
    t = res["trace"]
    ctx = {"trace": t, "config": cell["config"], "traffic": cell["traffic"],
           "peaks": bench.peaks(kind), "counters": t.counters,
           "flops": importlib.import_module(
               f"gpubench.flops.{cell['config']['family']}")}
    out = {}
    for m in cell["per_layer"]:
        value = bench.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    torch.set_num_threads(4)
    kind = torch.cuda.get_device_name(0)
    workload = importlib.import_module(
        f"gpubench.workloads.{cell['traffic']['kind']}")
    counters = sorted({c for m in cell["per_layer"] for c in getattr(
        bench.metric_reader(m["name"]), "COUNTERS", ())})
    res = workload.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START, counters=counters)
    forbidden = bench.forbidden_loaded()
    if forbidden:
        fail(f"modules of the JAX package were loaded: {forbidden}")
    checks = res["checks"]
    correct = checks.pop("correct")
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": bench.power_limit()}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"]}
    if args.trace:
        t = res["trace"]
        device.update(busy_s=t.busy_s(), window_s=t.wall_s)
        line["metrics"] = read_per_layer(cell, res, kind)
        line["device"] = device
        line["breakdown"] = {"device_ops": [list(x) for x in t.top_ops(10)],
                             "idle_gaps": [list(x) for x in t.idle_gaps(10)]}
    else:
        line["metrics"] = {m["name"]: {"value": res[m["name"]],
                                       "unit": m["unit"]}
                           for m in cell["end_to_end"]}
        line["device"] = device
        line["step_s"] = res["step_s"]
    line["reference_s"] = res["reference_s"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
