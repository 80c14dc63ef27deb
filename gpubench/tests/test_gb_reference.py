"""The plain reference against the port's CPU path at a small size: the
same weights and batch in float32 give the same loss and gradients; and
a whole run of a small cell on the CPU comes out correct."""
import importlib
import time

import pytest
import torch

from gpubench import weights as wts
from gpubench.data import TokenStream
from gpubench.reference import train as ref_train
from gpubench.tests._cells import cells, small_cell
from gpubench.workloads import train


@pytest.mark.parametrize("name", cells())
def test_reference_loss_and_grads_match_the_port_f32(name):
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.model import ModelOptions, build_model

    cell = small_cell(name)
    cfg = cell["config"]
    ref = importlib.import_module(f"gpubench.reference.{cfg['family']}")
    table = ref.param_table(cfg)
    w = {k: v.float() for k, v in wts.draw(table, 5, "cpu").items()}
    batch = TokenStream.from_traffic(cell["traffic"], cfg["vocab_size"],
                                     5).batch_at(0)
    tokens = torch.from_numpy(batch["tokens"]).long()
    targets = torch.from_numpy(batch["targets"]).long()

    model = build_model(train.model_config(cfg),
                        ModelOptions(dtype=torch.float32, remat="full"))
    params = ParamTree(train.nest({k: v.clone() for k, v in w.items()}))
    params.requires_grad_(True)
    loss = model.train_loss(params, {"tokens": tokens, "targets": targets})
    loss.backward()
    got = {k: p.grad for k, p in train.flatten(params).items()}

    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = ref.loss_sum(P, tokens, targets, cfg,
                            ref_train._matmul_f32) / targets.numel()
    ref_loss.backward()
    assert loss.item() == pytest.approx(ref_loss.item(), rel=1e-5)
    assert set(got) == set(P)
    for k, p in P.items():
        torch.testing.assert_close(got[k], p.grad, rtol=1e-3, atol=1e-6,
                                   msg=k)


@pytest.mark.parametrize("name", cells())
def test_small_run_on_the_cpu_is_correct(name):
    res = train.run(small_cell(name), 2**31 + 77, 0.5, False, "cpu",
                    time.perf_counter())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["correct"], res["checks"]
    assert res["train_tokens_per_s"] > 0 and res["setup_s"] > 0
