"""What every part of the harness shares: the checkout's layout, the lookup
of a cell's configuration, traffic, limits and metric readers by the names
in ``BENCHMARK.json``, and the device's description.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by name:

    gpubench/configs/<config>.json       the sizes as run, and their source
    gpubench/traffic/<traffic>.json      a traffic mix: parameters only
    gpubench/limits/<workload>.json      the limits of the correctness check
    gpubench/metrics/<metric>.py         one reader per per-layer metric
    gpubench/reference/<family>.py       the plain reference of a family
    gpubench/flops/<family>.py           operations and bytes of a family
    gpubench/workloads/<kind>.py         how a traffic kind is run

so that a later cell, mix or metric is added with files and entries only.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent                   # the checkout
SRC = ROOT / "src"                   # the program (repro_torch) lives here

# top-level module names that must never be loaded by a run (compared whole:
# "repro_torch" is the program, "repro" the JAX package it was ported from)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, spec: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The workload `name` with its configuration, traffic, limits and the
    metrics it reports, all read from their files."""
    spec = spec or benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    reports = {"end_to_end": [], "per_layer": []}
    for kind in reports:
        for m in spec[kind]:
            if name in m.get("workloads", [name]):
                reports[kind].append(m)
    return {
        "name": name,
        "chips": w["chips"],
        "config": load_json(ROOT / entry["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": reports["end_to_end"],
        "per_layer": reports["per_layer"],
    }


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at `path` as module `name` (a metric's reader,
    whose name may hold '-' or '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       "gpubench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def counter(spec: str) -> float:
    """The program's counter named "module:attr.attr" (a per-layer
    reader's ``COUNTERS`` entry), e.g.
    ``"repro_torch.kernels.ssd_scan.ops:ssd.bwd_launches"``."""
    module, path = spec.split(":")
    obj = importlib.import_module(module)
    for attr in path.split("."):
        obj = getattr(obj, attr)
    return obj


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named `kind` (``peaks.json``), or
    None for a card the table does not hold."""
    for key, val in load_json(HERE / "peaks.json")["cards"].items():
        if key in kind:
            return val
    return None


def forbidden_loaded(names=None) -> list:
    """Top-level names of `FORBIDDEN_MODULES` among the modules `names`
    (default: those this process loaded), each compared whole."""
    tops = {m.split(".", 1)[0] for m in list(
        sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it (one line per card),
    or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
