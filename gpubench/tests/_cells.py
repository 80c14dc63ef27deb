"""Small copies of the benchmark's cells for the CPU tests: the same
files, with every width and count cut so that a training step takes a
fraction of a second on the CPU."""
from __future__ import annotations

import copy

from gpubench import bench

SMALL = {"mamba2-780m": ({"num_layers": 2, "d_model": 64, "vocab_size": 512},
                         {"state_dim": 16, "head_dim": 16, "chunk_size": 32})}


def small_cell(name: str, batch: int = 4, seq_len: int = 128) -> dict:
    cell = bench.cell(name)
    cfg = copy.deepcopy(cell["config"])
    top, ssm = SMALL[cfg["name"]]
    cfg.update(top)
    cfg["ssm"].update(ssm)
    cell["config"] = cfg
    cell["traffic"] = dict(cell["traffic"], batch=batch, seq_len=seq_len)
    return cell


def cells() -> list:
    return [w["name"] for w in bench.benchmark()["workloads"]]
