"""The port's gradient-sync schedules, buckets and microbatch accumulation
(``repro_torch/core/overlap.py``) on one process, against the JAX package's
``repro/core/overlap.py``: the bucket partitions for every order with and
without layer provenance (seeded draws from the JAX suite's property-test
distributions: leaf sizes in [1, 1000], up to 20 leaves, 1-8 buckets),
``accumulate_grads`` for 1, 2 and 4 microbatches, ``microbatch_split``'s
divisibility check, and the backward-time HDOT buckets (:class:`GradBuckets`)
against the plain gradients bit for bit, with their issue order.
Multi-rank sums are in ``tests/test_torch_dist.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import both_models

from repro.core import overlap as joverlap
from repro_torch.core.overlap import (GradBuckets, accumulate_grads,
                                      grad_sync, make_buckets,
                                      microbatch_split, value_and_grad)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import tree_leaves


def _draw(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 21))
    sizes = rng.integers(1, 1001, n).tolist()
    depths = rng.integers(0, 6, n).tolist()
    return sizes, depths, int(rng.integers(1, 9))


@pytest.mark.parametrize("seed", range(16))
def test_make_buckets_matches_jax(seed):
    """The same leaf-index partition, in the same emission order, as the
    JAX package's for the legacy (no layers) schedule and every order with
    layers; every leaf exactly once; the legacy buckets keep tree order
    inside and meet the LPT balance bound."""
    sizes, depths, k = _draw(seed)
    keys = [f"w{i}" for i in range(len(sizes))]    # sorted as strings
    tree = {key: torch.zeros(s) for key, s in zip(keys, sizes)}
    jtree = {key: jnp.zeros((s,)) for key, s in zip(keys, sizes)}
    layers = dict(zip(keys, depths))
    cases = [(None, "reverse_topo")] + [(layers, o) for o in
                                         ("reverse_topo", "tree", "layer")]
    for lay, order in cases:
        got = [[i for i, _ in b] for b in make_buckets(tree, k, lay, order)]
        want = [[i for i, _ in b]
                for b in joverlap.make_buckets(jtree, k, lay, order)]
        assert got == want, (lay is not None, order)
        assert sorted(i for b in got for i in b) == list(range(len(sizes)))
    legacy = make_buckets(tree, k)
    assert all([i for i, _ in b] == sorted(i for i, _ in b) for b in legacy)
    leaves = tree_leaves(tree)
    loads = [sum(leaves[i].numel() for i, _ in b) for b in legacy]
    assert max(loads) <= sum(sizes) / min(k, len(sizes)) + max(sizes)


def test_make_buckets_rejects_bad_input():
    tree = {"a": torch.zeros(3), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="unknown bucket order"):
        make_buckets(tree, 2, {"a": 0, "b": 1}, "sideways")
    with pytest.raises(ValueError, match="layer-provenance tree has 1"):
        make_buckets(tree, 2, {"a": 0})
    assert make_buckets({}, 3) == []


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
def test_grad_sync_is_the_identity_on_one_rank(mode):
    """One rank has no process group: both schedules return the tree
    unchanged (dtypes too) and send nothing."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": torch.ones(7, dtype=torch.bfloat16), "c": torch.tensor(2.0)}
    want = {k: v.clone() for k, v in tree.items()}
    for mesh, axes in ((None, ("data",)),
                       (make_mesh((1,), ("data",), "cpu"), ("data",)),
                       (make_mesh((1, 1), ("pod", "data"), "cpu"),
                        ("pod", "data"))):
        out = grad_sync(tree, mesh, axes, mode=mode, num_buckets=2)
        for k in tree:
            assert out[k].dtype == want[k].dtype
            assert torch.equal(out[k], want[k])


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_accumulate_grads_matches_jax(steps):
    """Accumulated mean-loss grads against the JAX package's
    accumulate_grads on the same inputs (rtol 1e-5), and against the
    full-batch grads (linearity in the batch)."""
    rng = np.random.default_rng(0)
    w0 = np.asarray([1.0, -2.0, 0.5], np.float32)
    x = rng.standard_normal((8, 3)).astype(np.float32)
    y = rng.standard_normal(8).astype(np.float32)

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    tp = {"w": torch.from_numpy(w0).requires_grad_(True)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    loss, g = accumulate_grads(value_and_grad(tloss), tp, tb, steps)
    jl, jg = joverlap.accumulate_grads(
        jax.value_and_grad(jloss), {"w": jnp.asarray(w0)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, steps)
    full_l, full_g = value_and_grad(tloss)(tp, tb)
    for want_l, want_g in ((float(jl), np.asarray(jg["w"])),
                           (float(full_l), full_g["w"].numpy())):
        np.testing.assert_allclose(float(loss), want_l, rtol=1e-5)
        np.testing.assert_allclose(g["w"].numpy(), want_g, rtol=1e-5,
                                   atol=1e-6)
    assert g["w"].dtype == torch.float32


def test_microbatch_split():
    batch = {"tokens": torch.arange(24).reshape(8, 3)}
    mb = microbatch_split(batch, 4)
    assert mb["tokens"].shape == (4, 2, 3)
    assert torch.equal(mb["tokens"].reshape(8, 3), batch["tokens"])
    with pytest.raises(ValueError, match="batch 6.*accum steps 4"):
        microbatch_split({"x": torch.zeros(6, 2)}, 4)


def test_value_and_grad_gives_zeros_where_the_loss_does_not_reach():
    p = {"used": torch.ones(3, requires_grad=True),
         "unused": torch.ones(2, requires_grad=True)}
    loss, g = value_and_grad(lambda p, b: (p["used"] * b).sum())(p, 2.0)
    assert float(loss) == 6.0
    assert torch.equal(g["used"], torch.full((3,), 2.0))
    assert torch.equal(g["unused"], torch.zeros(2))


# ------------------------------------------- the backward-time HDOT buckets
def _model(scan, num_layers=4):
    _, _, tm, tp = both_models("internlm2-1.8b", "bf16", attn_impl="dense",
                               scan=scan, num_layers=num_layers)
    tp.requires_grad_(True)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (4, 17))
    return tm, tp, {"tokens": torch.from_numpy(toks[:, :-1]),
                    "targets": torch.from_numpy(toks[:, 1:])}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("scan", [True, False])
def test_grad_buckets_equal_the_plain_gradients(scan, accum):
    """On one rank the bucketed backward (grads accumulated into views of
    the bucket buffers; in float32 over 2 microbatches) gives the plain
    accumulate_grads result bit for bit, keeps the parameter dtypes with
    one microbatch, and issues every bucket once, in emission order."""
    tm, tp, batch = _model(scan)
    want_loss, want = accumulate_grads(value_and_grad(tm.train_loss), tp,
                                       batch, accum)
    sync = GradBuckets(tp, None, ("data",), 8, tm.param_layers(),
                       "reverse_topo", accum)
    sync.start()
    micro = microbatch_split(batch, accum)
    for j in range(accum):
        sync.last = j == accum - 1
        tm.train_loss(tp, {k: v[j] for k, v in micro.items()}).backward()
    got = sync.finish()
    sync.remove()
    assert sync.issued == list(range(len(sync.buckets)))
    for g, w, p in zip(got, tree_leaves(want), tree_leaves(tp)):
        assert g.dtype == (p.dtype if accum == 1 else torch.float32)
        assert torch.equal(g, w)


def test_grad_buckets_issue_before_the_first_layer_backward():
    """Unrolled: the buckets are cut on layer boundaries, deepest first,
    exactly make_buckets(order="reverse_topo")'s, and the head's bucket is
    issued before any gradient of layer 1 (depth 1) is ready, i.e. while
    the backward still has the first layer to run."""
    tm, tp, batch = _model(scan=False)
    layers = tm.param_layers()
    sync = GradBuckets(tp, None, ("data",), 8, layers, "reverse_topo")
    want = [[i for i, _ in b] for b in make_buckets(tp, 8, layers)]
    assert sync.buckets == want
    depth = tree_leaves(layers)
    assert [sorted({depth[i] for i in b}) for b in want] == [
        [5], [4], [3], [2], [1], [0]]
    seen = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, d=depth[i]: seen.append((d, len(sync.issued))))
        for i, p in enumerate(tree_leaves(tp))]
    sync.start()
    tm.train_loss(tp, batch).backward()
    sync.finish()
    for h in hooks:
        h.remove()
    sync.remove()
    first_layer = [n for d, n in seen if d == 1]
    assert first_layer and min(first_layer) >= 4   # head, layers 4, 3, 2
    assert sync.issued == list(range(6))


def test_grad_buckets_flush_a_bucket_the_loss_does_not_reach():
    """A leaf without a gradient keeps its bucket from completing in the
    backward; finish() still issues it, in order, with zeros."""
    p = {"a": torch.ones(3, requires_grad=True),
         "b": torch.ones(2, requires_grad=True)}
    sync = GradBuckets(p, None, ("data",), 2, {"a": 1, "b": 0})
    sync.start()
    (p["a"] * 3.0).sum().backward()
    assert sync.issued == [0]
    grads = sync.finish()
    sync.remove()
    assert sync.issued == [0, 1]
    assert torch.equal(grads[0], torch.full((3,), 3.0))
    assert torch.equal(grads[1], torch.zeros(2))


def test_grad_buckets_layout_is_zero_copy():
    """Each bucket holds one flat buffer per dtype and every .grad is a
    view of it (the autograd accumulation writes there directly)."""
    tm, tp, batch = _model(scan=True)
    sync = GradBuckets(tp, None, ("data",), 4, tm.param_layers())
    sync.start()
    flats = {f.data_ptr(): f for fs in sync.flats for f in fs}
    for p, g in zip(tree_leaves(tp), sync.grads):
        assert p.grad is g
        assert g._base is not None and g._base.data_ptr() in flats
    dtypes = [[f.dtype for f in fs] for fs in sync.flats]
    assert all(len(set(d)) == len(d) for d in dtypes)
    tm.train_loss(tp, batch).backward()
    before = [f.data_ptr() for fs in sync.flats for f in fs]
    sync.finish()
    sync.remove()
    assert [f.data_ptr() for fs in sync.flats for f in fs] == before
    assert all(p.grad is g for p, g in zip(tree_leaves(tp), sync.grads))


def test_grad_buckets_let_their_parameters_go():
    """After a backward through the buckets' hooks, dropping the
    parameters and the buckets frees both (the hooks hold the buckets
    weakly: a strong cycle runs through autograd's C++ state, where the
    cyclic GC cannot collect it, and kept a trainer's parameters and
    gradient buffers alive for the rest of the process); the hooks of
    buckets already gone do nothing."""
    import gc
    import weakref

    p = {"a": torch.ones(3, requires_grad=True),
         "b": torch.ones(2, requires_grad=True)}
    sync = GradBuckets(p, None, ("data",), 2, {"a": 1, "b": 0})
    sync.start()
    (p["a"] * 3.0 + p["b"].sum()).sum().backward()
    sync.finish()
    refs = [weakref.ref(p["a"]), weakref.ref(sync)]
    del sync
    gc.collect()
    assert refs[1]() is None
    (p["a"] * 2.0).sum().backward()          # the dead buckets' hook
    del p
    gc.collect()
    assert refs[0]() is None
