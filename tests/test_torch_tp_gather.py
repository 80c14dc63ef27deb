"""The TP train step's per-layer gathers, under the dry run (fake tensors
for rank 0 of a fake 16x16 group, no card): Qwen3-8B's ``train_4k`` cell
at 2 and 6 of its layers, scanned, remat "full", the step as it is
against the step that gathers every leaf's data blocks at its top
(``analysis.lint_targets.gather_all_tp_step``, the schedule the per-layer
gathers replaced). The per-layer step's temp grows by one layer's saved
input an added layer (its gathered blocks die within the layer and are
gathered again in the backward); the gather-all step's grows by at least
the layer's whole TP block more (the gathered block and its gradient
live through the step). The losses of both schedules on real ranks are
held by ``tests/test_torch_lint_gloo.py`` and the gloo TP files.
"""
from __future__ import annotations

import math

import pytest
import torch.distributed as dist

from repro_torch.analysis.lint_targets import gather_all_tp_step
from repro_torch.config.base import ParallelConfig
from repro_torch.config.registry import get_arch
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.rules import entry_axes


@pytest.fixture
def mesh():
    dryrun.fake_group(256)
    yield make_production_mesh(device="cpu")
    dist.destroy_process_group()


def _temp(mesh, layers):
    cell = dryrun._build("qwen3-8b", "train_4k", analysis=False,
                         num_layers=layers)
    return cell.lower(mesh).compile().memory_analysis().temp_size_in_bytes


def _gather_all(model, parallel, mesh, *a, **k):
    return gather_all_tp_step(model, parallel,
                              steps.TPPlan(model, parallel, mesh),
                              AdamWConfig())


def test_tp_step_temp_grows_by_a_layers_saved_input(mesh, monkeypatch):
    cfg = get_arch("qwen3-8b")
    per_layer = (_temp(mesh, 6) - _temp(mesh, 2)) / 4
    monkeypatch.setattr(steps, "make_tp_train_step", _gather_all)
    per_layer_all = (_temp(mesh, 6) - _temp(mesh, 2)) / 4
    # the layer's input, saved by remat "full": this DP replica's 16
    # sequences, this rank's 4096 / 16 rows, d_model wide, bf16
    saved = (256 // 16) * (4096 // 16) * cfg.d_model * 2
    assert abs(per_layer / saved - 1) < 0.05, (per_layer, saved)
    # one layer's TP block: its leaves cut over "model" only, bf16
    model = build_model(cfg, ModelOptions(scan_layers=True))
    plan = steps.TPPlan(model, ParallelConfig(), mesh)
    block = 0
    for i in plan.stack:
        spec, pspec = plan.specs[i], plan.shardings[i].spec
        cut = math.prod(mesh.shape[a] for e in pspec if e
                        for a in entry_axes(e) if a == plan.axis)
        block += math.prod(spec.shape[1:]) // cut * 2
    assert per_layer_all - per_layer >= block, (per_layer_all, per_layer,
                                                block)
