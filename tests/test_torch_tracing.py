"""The port's spans (``runtime/tracing.py``) on the CPU, on a 2-layer
Mamba-2 under remat "full" with the plain SSD: free and absent from the
autograd graph with no profiler; under ``torch.profiler`` every span of a
``Trainer.train(1)`` step as often as the step runs it, nested where it
runs; loss, gradients and the updated parameters bit-identical with the
profiler on and off."""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import ParallelConfig, RunConfig, TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.core.overlap import value_and_grad
from repro_torch.models.layers import tree_leaves
from repro_torch.runtime import tracing
from repro_torch.runtime.trainer import Trainer

LAYERS = 2
MARKER = "_MarkBackward"
PARTS = ("ssm.proj", "ssm.conv", "ssm.scan", "ssm.gate_norm")
# one Trainer.train(1) step: the forward and the recompute run each part
# once a layer (ssm.proj twice: the input projections and wo's), the
# backward once (ssm.proj.bwd twice)
PER_LAYER = {"ssm.proj": 2, "ssm.conv": 1, "ssm.scan": 1, "ssm.gate_norm": 1}
EXPECTED = {
    "trainer.place_batch": 1, "trainer.step": 1, "trainer.readback": 1,
    "trainer.log": 1, "step.fwd": 1, "step.bwd": 1,
    "layer.fwd": LAYERS, "layer.recompute": LAYERS,
    "adamw_update": 1, "linear_xent": 1, "linear_xent_backward": 1,
    **{p: 2 * LAYERS * n for p, n in PER_LAYER.items()},
    **{p + ".bwd": LAYERS * n for p, n in PER_LAYER.items()},
}


def _trainer(tmp_path, seed=1) -> Trainer:
    cfg = dataclasses.replace(get_arch("mamba2-780m").reduced(),
                              num_layers=LAYERS)
    run = RunConfig(
        model=cfg, parallel=ParallelConfig(remat="full"),
        train=TrainConfig(global_batch=2, seq_len=64, lr=1e-3,
                          warmup_steps=0, total_steps=100,
                          checkpoint_every=10 ** 9,
                          checkpoint_dir=str(tmp_path / "ckpt"), seed=seed))
    tr = Trainer(run, device="cpu")
    tr.init_state()
    return tr


def _graph_names(t: torch.Tensor) -> set:
    names, seen, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _spans(prof) -> list:
    """The spans of a profile: (name, start, end), microseconds."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in EXPECTED]


def _under(spans, inner, outer) -> int:
    """How many `inner` spans lie inside an `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return sum(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in spans if n == inner)


def test_off_is_a_shared_noop_and_leaves_the_graph_alone(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("trainer.step") is tracing.span("ssm.conv")
    assert tracing.layer_span() is tracing.span("x")
    tr = _trainer(tmp_path)
    batch = tr._place_batch(0)
    loss = tracing.step_bwd(tr.model.train_loss(tr.params, batch))
    names = _graph_names(loss)
    assert MARKER not in names
    with profile(activities=[ProfilerActivity.CPU]):
        marked = tracing.step_bwd(tr.model.train_loss(tr.params, batch))
    assert _graph_names(marked) == names | {MARKER}


def test_one_step_emits_every_span_nested_where_it_runs(tmp_path):
    tr = _trainer(tmp_path)
    tr.train(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(1)
    spans = _spans(prof)
    assert collections.Counter(n for n, _, _ in spans) == EXPECTED
    for part in PARTS:
        n = PER_LAYER[part] * LAYERS
        assert _under(spans, part, "layer.fwd") == n
        assert _under(spans, part, "layer.recompute") == n
        assert _under(spans, part + ".bwd", "step.bwd") == n
        assert _under(spans, part, "step.fwd") == n
    assert _under(spans, "layer.recompute", "step.bwd") == LAYERS
    assert _under(spans, "layer.fwd", "step.fwd") == LAYERS
    assert _under(spans, "linear_xent_backward", "step.bwd") == 1
    assert _under(spans, "adamw_update", "step.bwd") == 0
    for name in ("step.fwd", "step.bwd", "adamw_update"):
        assert _under(spans, name, "trainer.step") == 1
    # the loop body's four spans follow one another end to end
    body = sorted((s, e) for n, s, e in spans if n.startswith("trainer."))
    assert [n for n, _, _ in sorted(
        (x for x in spans if x[0].startswith("trainer.")),
        key=lambda x: x[1])] == ["trainer.place_batch", "trainer.step",
                                 "trainer.readback", "trainer.log"]
    for (_, e0), (s1, _) in zip(body, body[1:]):
        assert 0 <= s1 - e0 < 1000


def test_step_bwd_spans_a_plain_backward(tmp_path):
    tr = _trainer(tmp_path)
    batch = tr._place_batch(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("step.fwd"):
            loss = tr.model.train_loss(tr.params, batch)
        tracing.step_bwd(loss).backward()
    spans = _spans(prof)
    names = collections.Counter(n for n, _, _ in spans)
    assert names["step.bwd"] == 1
    assert names["linear_xent_backward"] == 1
    assert _under(spans, "linear_xent_backward", "step.bwd") == 1
    assert _under(spans, "ssm.scan.bwd", "step.bwd") == LAYERS
    assert all(p.grad is not None for p in tree_leaves(tr.params))


def test_step_number_is_the_step_spans_argument():
    rec = tracing.span("trainer.step", "7")
    assert rec is tracing._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        rec = tracing.span("trainer.step", "7")
    assert (rec.name, rec.args) == ("trainer.step", "7")


@pytest.mark.parametrize("on_first", [False, True])
def test_loss_grads_and_step_bit_identical_with_the_profiler(tmp_path,
                                                             on_first):
    tr = _trainer(tmp_path / "a")
    batch = tr._place_batch(3)
    f = value_and_grad(tr.model.train_loss)
    runs = []
    for on in (on_first, not on_first):
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                runs.append(f(tr.params, batch))
        else:
            runs.append(f(tr.params, batch))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)

    off, on = _trainer(tmp_path / "b"), _trainer(tmp_path / "c")
    off.train(2)
    on.train(1)
    with profile(activities=[ProfilerActivity.CPU]):
        on.train(1)
    assert [m["loss"] for m in off.metrics_log] == [
        m["loss"] for m in on.metrics_log]
    for a, b in zip(tree_leaves(off.params), tree_leaves(on.params),
                    strict=True):
        assert torch.equal(a, b)
