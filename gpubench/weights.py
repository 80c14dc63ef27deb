"""The weights of a run, drawn from its seed on the device: one generator,
one draw per leaf of the family's reference table
(``reference/<family>.py`` ``param_table``), in path order, each in the
dtype the configuration stores it in. Both the program and the reference
are handed these; neither draws its own.

Draws: ``normal`` is N(0, 1/fan_in); ``ones`` is ones; Mamba-2's
``a_log`` is log A with A uniform on [1, 16] and ``dt_bias`` the inverse
softplus of a dt log-uniform on [0.001, 0.1], as the paper's code draws
them.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(table: List[Dict], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out = {}
    for leaf in sorted(table, key=lambda e: e["path"]):
        shape, init = leaf["shape"], leaf["init"]
        if init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "normal":
            t = torch.randn(shape, generator=gen, device=device)
            t.mul_(1.0 / math.sqrt(leaf["fan_in"]))
        elif init == "a_log":
            u = torch.rand(shape, generator=gen, device=device)
            t = torch.log(1.0 + 15.0 * u)
        elif init == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)).clamp(min=1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            raise ValueError(f"unknown draw {init!r} for {leaf['path']}")
        out[leaf["path"]] = t.to(DTYPES[leaf["dtype"]])
    return out
