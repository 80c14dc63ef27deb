"""The port's MoE block (``repro_torch/models/moe.py``) and its all-to-all
schedule (``repro_torch/core/a2a_scan.py``) against the JAX package on the
CPU, one rank; the expert-parallel path on gloo ranks is in
``tests/test_torch_dist.py``.

Tolerances: the dispatch tables and the capacity are integers, held bit
for bit. ``moe_apply_dense`` in float32: routing equal (compared first, so
a flipped decision is named as such), the output within 1e-5 of its
largest entry, the aux loss within 1e-6; in bf16 the model tests' rule
(rtol 3e-2, atol 6e-2, or JAX's own bf16-vs-f32 error where that is more,
``tests/test_torch_models.py``).
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_arch as jax_arch
from repro.models import moe as jmoe
from repro_torch.config.registry import get_arch
from repro_torch.core.a2a_scan import a2a_scan
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe

ARCH = "qwen3-moe-30b-a3b"


def _cfgs(**moe_kw):
    t, j = get_arch(ARCH).reduced(), jax_arch(ARCH).reduced()
    return (dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw)),
            dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw)))


def _params(rng, d, E, f):
    """Numpy leaves of moe_specs' shapes, normal / sqrt(fan_in) (the
    router's fan_in is d, an expert leaf's E, as the init takes them)."""
    def draw(shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[0])).astype(
            np.float32)
    return {"router": draw((d, E)), "gate": draw((E, d, f)),
            "up": draw((E, d, f)), "down": draw((E, f, d))}


def _both(p, tdtype, jdtype):
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else tdtype) for k, v in p.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdtype)
          for k, v in p.items()}
    return tp, jp


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (2048, 128, 8, 1.25), (2047, 128, 8, 1.25), (1, 128, 8, 1.25),
    (32, 8, 2, 8.0), (16, 8, 2, 8.0), (40, 4, 2, 1.25), (7, 4, 2, 0.1)])
def test_capacity_matches_jax(tokens, experts, k, factor):
    assert moe.capacity(tokens, experts, k, factor) == jmoe.capacity(
        tokens, experts, k, factor)


def _assignments(rng, G, T, K, E, skew=None):
    """(G, T, K) distinct expert ids per token; `skew` sends every token's
    first choice to expert 0 (overflowing it)."""
    def one():
        if skew is None:
            return rng.choice(E, K, replace=False)
        return np.concatenate([[0], 1 + rng.choice(E - 1, K - 1,
                                                   replace=False)])
    return np.stack([np.stack([one() for _ in range(T)])
                     for _ in range(G)]).astype(np.int64)


@pytest.mark.parametrize("G,T,K,E,C,skew", [
    (3, 17, 2, 4, 11, None),     # ample: nothing dropped
    (2, 40, 2, 4, 5, None),      # every expert overflows
    (2, 64, 8, 16, 9, None),     # top-8 of 16
    (1, 30, 2, 8, 4, "first"),   # one expert takes every token first
    (4, 5, 2, 4, 1, None)])      # capacity 1
def test_dispatch_tables_bit_equal_jax(G, T, K, E, C, skew):
    """gather_ids, rank and keep equal JAX's: ranks token-major within each
    expert (later tokens dropped), T (the zero row) in every empty slot;
    kept slots are unique, so the scatter never writes one twice."""
    a = _assignments(np.random.default_rng(G * 100 + T), G, T, K, E, skew)
    want = jmoe._dispatch_tables(jnp.asarray(a, jnp.int32), E, C)
    got = moe._dispatch_tables(torch.from_numpy(a), E, C)
    for name, w, g in zip(("gather_ids", "rank", "keep"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    gather_ids, rank, keep = got
    for g in range(G):
        kept = (a[g] * C + rank[g].numpy())[keep[g].numpy()]
        assert len(set(kept.tolist())) == kept.size
        # each kept assignment's slot holds its token
        tok = np.broadcast_to(np.arange(T)[:, None], (T, K))[keep[g].numpy()]
        assert np.array_equal(gather_ids[g].reshape(-1).numpy()[kept], tok)
    if skew is not None:
        assert keep[:, :C, 0].all() and not keep[:, C:, 0].any()


def test_routing_ties_follow_lax_top_k():
    """Tied router probabilities (built: equal router columns, and zero
    logits) give lax.top_k's order, the lower expert id first, and the
    same dispatch; torch.topk does not promise that order."""
    rng = np.random.default_rng(3)
    d, E, K = 16, 8, 3
    router = rng.standard_normal((d, E)).astype(np.float32)
    router[:, 5] = router[:, 2]              # experts 2 and 5 always tie
    router[:, 7] = router[:, 1]
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    x[1, 0] = 0.0                            # every expert ties
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    jw, ja = jax.lax.top_k(jprobs, K)
    _, tw, ta = moe._route(torch.from_numpy(x), torch.from_numpy(router), K)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ta[1, 0].numpy(), [0, 1, 2])
    np.testing.assert_allclose(
        tw.numpy(), np.asarray(jw / jnp.sum(jw, -1, keepdims=True)),
        rtol=1e-6, atol=1e-7)


def _routes(tx, tp, jx, jp, K):
    _, _, ta = moe._route(tx, tp["router"], K)
    logits = jx.astype(jnp.float32) @ jp["router"]
    _, ja = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flips = np.argwhere((ta.numpy() != np.asarray(ja)).any(-1))
    assert not flips.size, f"routing differs at (b, s) {flips.tolist()}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,K,factor", [(4, 2, 1.25), (4, 2, 0.5),
                                        (16, 4, 1.0), (8, 2, 8.0)])
def test_moe_apply_dense_matches_jax(dtype, E, K, factor):
    """moe_apply_dense against JAX's on one numpy draw, at the configs'
    capacity factor 1.25, with experts that overflow (0.5, 1.0) and with
    ample capacity (8.0). In bf16 an entry may also lie as far from JAX's
    as JAX's own bf16 output lies from its float32 output on the same
    bf16-rounded inputs, at their worst (the rule of
    tests/test_torch_models.py)."""
    cfg, jcfg = _cfgs(num_experts=E, top_k=K, capacity_factor=factor)
    rng = np.random.default_rng(E + K)
    p = _params(rng, cfg.d_model, E, cfg.moe.d_ff_expert)
    x = (rng.standard_normal((3, 40, cfg.d_model)) * 0.3).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    tp, jp = _both(p, tdt, jdt)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    _routes(tx, tp, jx, jp, K)
    ty, taux = moe.moe_apply_dense(tp, tx, cfg)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply_dense(p, x, jcfg))(jp, jx)
    assert ty.dtype == tdt and taux.dtype == torch.float32
    want, got = np.asarray(jy, np.float32), ty.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        up = {k: v.astype(jnp.float32) for k, v in jp.items()}
        j32, _ = jmoe.moe_apply_dense(up, jx.astype(jnp.float32), jcfg)
        bound = np.maximum(6e-2 + 3e-2 * np.abs(want),
                           np.abs(want - np.asarray(j32)).max())
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if factor <= 1.0:       # the case drops: a routed assignment is cut
        C = moe.capacity(40, E, K, factor)
        _, _, keep = moe._dispatch_tables(
            moe._route(tx, tp["router"], K)[2], E, C)
        assert not bool(keep.all())


class _StubMesh:
    """A mesh's shape, for the path choice and the checks that precede any
    communication."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class _StubCtx:
    def __init__(self, n):
        self.n = n

    def axis_size(self, name):
        return self.n


@pytest.mark.parametrize("E", [4, 8])
def test_moe_apply_takes_the_jax_path_for_each_mesh(monkeypatch, E):
    """For each model-axis size and input shape, moe_apply takes the path
    (dense, EP over the sequence, EP with the batch as tokens) that the
    JAX package's moe_apply takes under a sharding context of that size;
    a mesh without a "model" axis, or none, is dense."""
    cfg, jcfg = _cfgs(num_experts=E)
    taken = {}

    def rec(tag):
        def f(p, x, *a, **kw):
            taken[tag] = (tag, tuple(x.shape), kw.get("tokens_on_batch",
                                                      False))
            return x, 0.0
        return f

    monkeypatch.setattr(moe, "moe_apply_ep", rec("ep"))
    monkeypatch.setattr(moe, "moe_apply_dense", rec("dense"))
    monkeypatch.setattr(jmoe, "moe_apply_ep",
                        lambda p, x, cfg, ctx, **kw: rec("ep")(p, x, **kw))
    monkeypatch.setattr(jmoe, "moe_apply_dense", rec("dense"))
    import repro.sharding.rules as rules

    for n in (1, 2, 3, 4, 8):
        for shape in ((4, 32), (2, 12), (8, 1), (3, 1), (2, 13)):
            x = np.zeros(shape + (cfg.d_model,), np.float32)
            taken.clear()
            monkeypatch.setattr(rules, "current_context",
                                lambda n=n: _StubCtx(n))
            jmoe.moe_apply({}, jnp.asarray(x), jcfg)
            want = taken.pop("ep", None) or taken.pop("dense")
            for mesh in (_StubMesh(model=n), _StubMesh(data=2, model=n)):
                taken.clear()
                moe.moe_apply({}, torch.from_numpy(x), cfg, mesh)
                got = taken.pop("ep", None) or taken.pop("dense")
                assert got == want, (n, shape)
    for mesh in (None, _StubMesh(data=4)):
        taken.clear()
        moe.moe_apply({}, torch.zeros(4, 32, cfg.d_model), cfg, mesh)
        assert "dense" in taken


def test_a2a_scan_rejects_indivisible_chunks():
    mesh = _StubMesh(model=2)
    mesh.groups = {"model": None}
    with pytest.raises(ValueError, match="chunks=3"):
        a2a_scan(torch.zeros(4, 10, 8), lambda v, k: v, mesh, "model",
                 chunks=3, dim=1)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_a2a_scan_issue_order_on_one_rank(chunks):
    """On an axis of one rank (the all-to-alls are no-ops) the schedule is
    the reference's: dispatch(0) as the prologue, then for each slice k
    dispatch(k+1) before compute(k), combine(k) before compute(k+1); the
    slices' results concatenate to compute_fn over the whole tensor."""
    mesh = make_mesh((1,), ("model",), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 8, 5)).astype(np.float32))
    log = []
    seen = []

    def fn(v, k):
        seen.append(v.shape[2])
        return v * 2.0 + 1.0

    y = a2a_scan(x, fn, mesh, "model", chunks=chunks, dim=2, log=log)
    assert torch.equal(y, x * 2.0 + 1.0)
    assert seen == [8 // chunks] * chunks
    want = [("dispatch", 0)]
    for k in range(chunks):
        if k + 1 < chunks:
            want.append(("dispatch", k + 1))
        want += [("compute", k), ("combine", k)]
    assert log == want
