"""The schedule linter on the real issue order of four gloo ranks: one
logged step each of streaming ZeRO-3, the TP decode step, the TP train
step of a MoE model under expert parallelism (``a2a_scan`` at Q = 2) and
the dense TP train step, reduced configs, linted on every rank under the
expectations the lint targets use (``analysis.lint_targets``:
``streaming_ctx``, ``decode_ctx``, ``tp_train_ctx``). The same jobs run on
four cards in ``tests/test_torch_cuda.py`` (``test_nccl_4_lints_real_logs``
and ``test_nccl_4_tp_qwen3_8b_2x2_gathers_per_layer``, at published
widths). The dense step also runs first with the gather-all schedule the
per-layer gathers replaced: its first loss (the forward) is bit-equal.

Each spawn (``tests/_torch_dist.py``) has one deadline, so a hung
collective fails the test instead of hanging it.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
from _torch_dist import spawn

TP = dict(arch="qwen3-8b", steps=2, global_batch=8, seq_len=32, lr=3e-4,
          meshes=[[2, 2]], trace=False, reduced=True)
STEPS = dict(arch="qwen3-8b", layers=2, steps=2, global_batch=8, seq_len=32,
             lr=3e-4, bf16=True, slots=8, max_len=64, reduced=True,
             # the reduced model's 2 KV heads do not divide 4 ranks
             decode_mesh=[2, 2])
# 16 tokens a shard: a capacity of 10 slots, which Q = 2 divides
MOE = dict(arch="qwen3-moe-30b-a3b", layers=2, steps=1, global_batch=8,
           seq_len=64, lr=3e-4, meshes=[[1, 4]], chunks=2, trace=False,
           lint=True, prefix="moe_", reduced=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(dict(mesh=[4], backend="gloo", lint_steps=STEPS,
                      tp_train_full=[dict(TP, prefix="ga_", gather_all=True),
                                     dict(TP, prefix="pl_", lint=True), MOE]),
                 None, tmp_path_factory.mktemp("lint_gloo"), 300)


@pytest.mark.parametrize("tag", ["zero3", "decode", "moe_m1x4", "pl_m2x2"])
def test_real_log_lints_clean_on_every_rank(ranks, tag):
    for out in ranks:
        report = json.loads(str(out[f"{tag}_lint"]))
        assert bool(out[f"{tag}_lint_ok"]) and report["ok"], report
        assert report["n_collectives"] > 0


def test_per_layer_gathers_keep_the_forward(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["pl_m2x2_loss"],
                                      ranks[0]["pl_m2x2_loss"])
        assert out["ga_m2x2_loss"][0] == out["pl_m2x2_loss"][0]
