"""Readings that the limits of a cell's check are set from (not run by
the benchmark's own runs):

    python3 gpubench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--frozen-seeds 1] \
        [--device cuda]

For each seed of ``--seeds`` the program's followed steps against the
reference (the lower readings; the reference runs once a seed, for all
the readings of that seed); for each of ``--control-seeds`` the
control, the reference computed with fp8 weight products put in the
program's place (the upper readings); for each of ``--fault-seeds`` the
program with half of each batch left out and the loss's mean taken over
the rest; for each of ``--frozen-seeds`` the program whose step returns
its state unchanged. One JSON line a reading, on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gpubench import bench, check  # noqa: E402
from gpubench.workloads import train  # noqa: E402


def half_batch(trainer) -> None:
    """Fault: the step sees only the first half of each batch's rows."""
    place = trainer._place_batch

    def placed(step):
        batch = place(step)
        return {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    trainer._place_batch = placed


def frozen(trainer) -> None:
    """Fault: the step returns the state it was given, unchanged."""
    def step_fn(params, opt_state, batch):
        loss = trainer.model.train_loss(params, batch).detach()
        return params, opt_state, {"loss": loss}
    trainer._build_step = lambda: step_fn


FAULTS = {"half_batch": half_batch, "frozen": frozen}


def readings(cell, seed: int, device: str, modes=("program",),
             detail: bool = False) -> list:
    """One row {"seed", "mode", every number of ``check.readings``} for
    each of `modes` ("program", "control" or a fault's name) on one seed,
    all against one run of the reference. With `detail`, also each step's
    loss gap and the three worst leaves of each leaf number."""
    ref = train.reference(cell, seed, device)
    train.free(device)
    rows = []
    for mode in modes:
        t0 = time.perf_counter()
        if mode == "control":
            other = train.reference(cell, seed, device, "fp8")
        else:
            trainer, other = train.start(cell, seed, device,
                                         FAULTS.get(mode))
            del trainer
        train.free(device)
        row = {"seed": seed, "mode": mode, **check.readings(other, ref)}
        if detail:
            keys = check.leaves_compared(ref)
            row["step_gaps"] = [p - r for p, r in zip(other["loss"],
                                                      ref["loss"])]
            for part in ("grad", "change"):
                gaps = check.leaf_gaps(other[part], ref[part], keys)
                row[f"{part}_worst"] = sorted(gaps.items(),
                                              key=lambda kv: -kv[1])[:3]
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--frozen-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    plan: dict = {}          # seed -> its modes, one reference a seed
    for text, mode in ((args.seeds, "program"),
                       (args.control_seeds, "control"),
                       (args.fault_seeds, "half_batch"),
                       (args.frozen_seeds, "frozen")):
        for s in seeds(text):
            plan.setdefault(s, []).append(mode)
    for seed, modes in plan.items():
        for row in readings(cell, seed, args.device, modes, detail=True):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
