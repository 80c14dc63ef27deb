"""The port on several gloo ranks on the CPU against the JAX package on one
device: heat2d_solve on 2 ranks (2,), 4 ranks (4,) and a (2, 2) grid in both
schedules, the sharded tile sweep on (2, 2), and the peeled hdot scan with
its exchanges counted per axis; rk3_solve on (2,), (4,) and (2, 2),
hpccg_solve on (2,), (2, 2) and (2, 2, 2) (the corner chain on every axis),
both schedules, with their exchanges and all-reduces counted per axis; and
hierarchical_allreduce on a (2, 2) (pod, data) mesh, plain and through the
int8 codec, against numpy's sum and against the JAX package's staged
all-reduce on four forced host devices (a subprocess); MoE expert
parallelism (moe_apply_ep over a2a_scan) on (2,) and (4,) ("model",) and
(2, 2) ("data", "model") against the JAX package's dense dispatch, with
Q = 1, 2, 4 capacity slices and the all-to-alls' issue order; ZeRO-3
(gathering all and streaming) on (2,), (4,) and (2, 2) ("pod", "data")
against the replicated trainer on one rank, streaming bit-equal to
gathering all, with each rank's shards and the collectives' issue order;
the TP rings (ag_matmul, matmul_rs) on (2,), (3,) and (4,) ranks against
numpy and the JAX package's rings on forced host devices, with their
point-to-point sends counted, and the TP decode step on (1, 4) and (2, 2)
("data", "model") against the port's and the JAX package's one-device
servers and the JAX build_decode_step; and the encoder-decoder's
data-parallel trainer (reduced Whisper) on (2,) against one rank, its
decoder stack's gradient buckets issued before its encoder's.

Each job spawns its ranks as separate processes (``tests/_torch_dist.py``,
which imports no jax) with a FileStore of their own in a temporary
directory and one thread each; the whole spawn has a deadline, so a hung
rendezvous fails its tests instead of stalling the suite. The parent makes
the input with numpy, computes the JAX reference on one device and compares
the gathered global results. The stencils here add first and multiply by
0.25 last, so every backend does the same IEEE operations in the same order
and the Heat2D comparisons are exact. RK3 and HPCCG are held to the JAX
suite's tolerances against JAX (rtol 1e-5, atol 1e-6; the history within
rtol 1e-4, since the rank count changes the order in which a dot product is
summed); inside the port RK3 is bit-equal across rank counts and hdot to
two_phase, and so is HPCCG's hdot to its two_phase on each rank count.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import (RING_CASES, TP_PROMPTS, _star, _sum3, app_input,
                         check_issue_order, check_zero3_log, moe_config,
                         moe_input, params_close, ring_input, spawn,
                         tp_admitted, tp_model, tp_serve)
from repro.core import halo as jhalo
from repro.core import stencil as jst
from repro.launch.mesh import make_grid_mesh as jgrid_mesh
from repro.launch.mesh import make_mesh as jmesh
from tests.test_system import run_devices
from repro_torch.core import stencil as tst
from repro_torch.kernels.heat2d.ops import heat2d_sweep
from repro_torch.launch.mesh import make_mesh as tmesh

SHAPE = (48, 40)
ITERS, SCAN_STEPS = 10, 4
SPAWN_DEADLINE_S = 180

JOBS = {
    # 2 ranks: slabs; the periodic scan has both messages on one peer
    "2": dict(mesh=[2], axes=["data"]),
    # 4 ranks: slabs, a skewed cut; the scan on (4, 1) has a size-1 axis
    "4": dict(mesh=[4], axes=["data"],
              chunk_weights=[[5.0] * 3 + [1.0] * 7],
              scan_mesh=[4, 1], scan_axes=["rows", "cols"]),
    # a (2, 2) grid: blocks, a skewed cut, the sharded tile sweep
    "2x2": dict(mesh=[2, 2], axes=["rows", "cols"],
                chunk_weights=[[9.0] * 6 + [1.0] * 16, None],
                sweep_tile=[8, 10], sweep_sweeps=2),
}


def _spawn(name: str, workdir: Path):
    u0 = np.random.default_rng(11).uniform(0.0, 1.0, SHAPE).astype(
        np.float32)
    job = dict(JOBS[name], iters=ITERS, scan_steps=SCAN_STEPS)
    return u0, spawn(job, u0, workdir, SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _spawn(name, tmp_path_factory.mktemp(f"job{name}"))
        return cache[name]
    return get


def _jax_mesh(axes):
    return jmesh((1,), ("data",)) if len(axes) == 1 else jgrid_mesh(1, 1)


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("name", list(JOBS))
def test_heat2d_solve_ranks_match_jax(runs, name, mode):
    u0, ranks = runs(name)
    axes = tuple(JOBS[name]["axes"])
    want, wres = jst.heat2d_solve(jnp.asarray(u0), _jax_mesh(axes), axes,
                                  ITERS, "two_phase")
    for out in ranks:  # every rank gathered the same global grid
        np.testing.assert_array_equal(out[f"solve_{mode}"], np.asarray(want))
        np.testing.assert_array_equal(out[f"res_{mode}"], np.asarray(wres))
        np.testing.assert_array_equal(out["solve_hdot"],
                                      out["solve_two_phase"])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", list(JOBS))
def test_peeled_scan_matches_jax_and_counts_exchanges(runs, name, periodic):
    """`s` hdot steps issue exactly `s` exchanges per axis of size > 1 (one
    fill plus s - 1 in the loop, none in the peeled drain) and none on a
    size-1 axis; the result equals the JAX scan of the global grid."""
    u0, ranks = runs(name)
    job = JOBS[name]
    axes = tuple(job.get("scan_axes", job["axes"]))
    sizes = job.get("scan_mesh", job["mesh"])
    fn = _star if len(axes) == 2 else _sum3
    scan_axes = tuple((a, d) for d, a in enumerate(axes))
    spec = P(*axes) if len(axes) == 2 else P(axes[0])
    want, _ = jax.jit(jax.shard_map(
        lambda x: jhalo.halo_scan_nd(x, fn, scan_axes, 1, SCAN_STEPS,
                                     periodic, "hdot", 2),
        mesh=_jax_mesh(axes), in_specs=(spec,),
        out_specs=(spec, P())))(jnp.asarray(u0))
    tag = "periodic" if periodic else "open"
    expect = [SCAN_STEPS if s > 1 else 0 for s in sizes]
    for out in ranks:
        np.testing.assert_array_equal(out[f"scan_{tag}"], np.asarray(want))
        assert out[f"sends_{tag}"].tolist() == expect


def test_sweep_sharded_2x2_matches_global_sweep(runs):
    u0, ranks = runs("2x2")
    job = JOBS["2x2"]
    want = heat2d_sweep(torch.from_numpy(u0), tuple(job["sweep_tile"]),
                        job["sweep_sweeps"]).numpy()
    for out in ranks:
        np.testing.assert_array_equal(out["sweep"], want)


# ------------------------------------------- RK3, HPCCG, the staged sum
# RK3's grid keeps the pipelined schedule on every rank count: >= 16 cells
# of each sharded dim a rank; HPCCG's keeps >= 4 z cells a rank
RK3 = dict(shape=[6, 32, 64], seed=5, steps=3, dt=0.01)
HPCCG = dict(shape=[8, 8, 16], seed=6, iters=12)
SLAB, PAIR, TRIPLE = ["data"], ["rows", "cols"], ["planes", "rows", "cols"]
# expert parallelism: reduced Qwen3-MoE with 8 experts, top-2 and ample
# capacity (tests/test_moe_ep.py's setup), (4, 32) tokens; the capacity of
# every model-axis size here (C = 32 on 2 ranks, 16 on 4) takes Q = 1, 2, 4
MOE = dict(seed=21, experts=8, top_k=2, factor=8.0, batch=4, seq=32,
           decode_batch=8, chunks=[1, 2, 4], model_batch=4)
# ZeRO-3: reduced qwen3-8b in float32, gathering all and streaming on the
# per-layer layout, (8, 16) tokens a step (tests/_torch_dist.py run_zero3)
ZERO3 = dict(arch="qwen3-8b", steps=3, global_batch=8, seq_len=16, lr=5e-3,
             cases=["gather", "stream"])
# the TP rings: 15 rows a rank (uneven bidirectional pieces, as
# tests/test_system.py's), 4 columns a rank, inner width 8; the TP decode
# step: reduced qwen3-8b with 2 layers in float32, 4 slots, max_len 16
# (tests/test_decode_tp.py's setup), with 8/4 heads so that (1, 4) divides
RING = dict(seed=30, rows=15, cols=4, m=8)
TP = dict(layers=2, heads=[8, 4], seed=0, slots=4, max_len=16)
APP_JOBS = {
    "2": dict(mesh=[2], rk3=dict(RK3, mesh=[2], axes=SLAB),
              hpccg=dict(HPCCG, mesh=[2], axes=SLAB),
              moe=dict(MOE, mesh=[2], axes=["model"]),
              zero3=dict(ZERO3, mesh=[2], axes=["data"]),
              tp_ring=dict(RING, mesh=[2])),
    "3": dict(mesh=[3], tp_ring=dict(RING, mesh=[3])),
    "4": dict(mesh=[4], rk3=dict(RK3, mesh=[4], axes=SLAB),
              moe=dict(MOE, mesh=[4], axes=["model"]),
              zero3=dict(ZERO3, mesh=[4], axes=["data"]),
              tp_ring=dict(RING, mesh=[4]),
              tp_decode=dict(TP, mesh=[1, 4])),
    "2x2": dict(mesh=[2, 2], rk3=dict(RK3, mesh=[2, 2], axes=PAIR),
                hpccg=dict(HPCCG, mesh=[2, 2], axes=PAIR),
                allreduce=dict(mesh=[2, 2], shape=[16, 8], seed=100,
                               per_rank=True, odd_rows=5),
                moe=dict(MOE, mesh=[2, 2], axes=["data", "model"]),
                zero3=dict(ZERO3, mesh=[2, 2], axes=["pod", "data"]),
                tp_decode=dict(TP, mesh=[2, 2])),
    "2x2x2": dict(mesh=[2, 2, 2],
                  hpccg=dict(HPCCG, mesh=[2, 2, 2], axes=TRIPLE)),
}
RK3_JOBS = [k for k, v in APP_JOBS.items() if "rk3" in v]
MOE_JOBS = [k for k, v in APP_JOBS.items() if "moe" in v]
ZERO3_JOBS = [k for k, v in APP_JOBS.items() if "zero3" in v]
HPCCG_JOBS = [k for k, v in APP_JOBS.items() if "hpccg" in v]
RING_JOBS = [k for k, v in APP_JOBS.items() if "tp_ring" in v]
TP_JOBS = [k for k, v in APP_JOBS.items() if "tp_decode" in v]


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = spawn(APP_JOBS[name], None,
                                tmp_path_factory.mktemp(f"app{name}"),
                                SPAWN_DEADLINE_S)
        return cache[name]
    return get


def _jax_app_mesh(axes):
    return {1: lambda: jmesh((1,), tuple(axes)),
            2: lambda: jgrid_mesh(1, 1, axes=tuple(axes)),
            3: lambda: jgrid_mesh(1, 1, 1, axes=tuple(axes))}[len(axes)]()


def _one_rank_mesh(axes):
    return tmesh((1,) * len(axes), tuple(axes), "cpu")


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("name", RK3_JOBS)
def test_rk3_ranks_match_jax_and_one_rank(app_runs, name, mode):
    """Within the JAX suite's tolerance of JAX on one device; bit-equal to
    the port on one rank and to the other schedule; 3·steps exchanges on
    every axis in both schedules (the drain peeled)."""
    spec = APP_JOBS[name]["rk3"]
    v0 = app_input(spec)
    want = jst.rk3_solve(jnp.asarray(v0), _jax_app_mesh(spec["axes"]),
                         tuple(spec["axes"]), spec["steps"], spec["dt"],
                         mode)
    one = tst.rk3_solve(torch.from_numpy(v0), _one_rank_mesh(spec["axes"]),
                        tuple(spec["axes"]), spec["steps"], spec["dt"], mode)
    for out in app_runs(name):
        np.testing.assert_allclose(out[f"rk3_{mode}"], np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out[f"rk3_{mode}"], one.numpy())
        np.testing.assert_array_equal(out["rk3_hdot"], out["rk3_two_phase"])
        assert out[f"rk3_sends_{mode}"].tolist() == [3 * spec["steps"]] * len(
            spec["mesh"])
        assert not out[f"rk3_reduces_{mode}"].any()


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("name", HPCCG_JOBS)
def test_hpccg_ranks_match_jax(app_runs, name, mode):
    """The residual history within rtol 1e-4 of JAX on one device; hdot
    equal to two_phase bit for bit on the same ranks; `iters` exchanges and
    2·iters + 1 all-reduces on every axis in both schedules."""
    spec = APP_JOBS[name]["hpccg"]
    b = app_input(spec)
    _, want = jst.hpccg_solve(jnp.asarray(b), _jax_app_mesh(spec["axes"]),
                              tuple(spec["axes"]), spec["iters"], mode)
    n_axes = len(spec["mesh"])
    for out in app_runs(name):
        np.testing.assert_allclose(out[f"hpccg_hist_{mode}"],
                                   np.asarray(want), rtol=1e-4)
        assert out[f"hpccg_hist_{mode}"][-1] < out[f"hpccg_hist_{mode}"][0]
        for key in ("hpccg_{}", "hpccg_hist_{}"):
            np.testing.assert_array_equal(out[key.format("hdot")],
                                          out[key.format("two_phase")])
        assert out[f"hpccg_sends_{mode}"].tolist() == [spec["iters"]] * n_axes
        assert out[f"hpccg_reduces_{mode}"].tolist() == [
            2 * spec["iters"] + 1] * n_axes


def test_hpccg_ranks_solve_the_system(app_runs):
    """The 8-rank solution satisfies A x ~= b as well as one rank's does."""
    spec = APP_JOBS["2x2x2"]["hpccg"]
    b = torch.from_numpy(app_input(spec))
    x = torch.from_numpy(app_runs("2x2x2")[0]["hpccg_hdot"])
    one, _ = tst.hpccg_solve(b, _one_rank_mesh(TRIPLE), tuple(TRIPLE),
                             spec["iters"])
    rel = [float(torch.linalg.norm(tst._stencil27_matvec(v, None, (), "hdot")
                                   - b) / torch.linalg.norm(b))
           for v in (x, one)]
    assert rel[0] < 2 * rel[1] + 1e-6, rel


# ------------------------------------------------- MoE expert parallelism
@pytest.fixture(scope="module")
def moe_dense():
    """The JAX package's moe_apply_dense on the whole MoE job input: y,
    sum(y^2) + aux and its gradients (float32), and the decode output."""
    import dataclasses

    from repro.config.registry import get_arch as jax_arch
    from repro.models import moe as jmoe

    cfg = jax_arch("qwen3-moe-30b-a3b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=MOE["experts"], top_k=MOE["top_k"],
        capacity_factor=MOE["factor"]))
    p, x, xd = moe_input(MOE)
    p = {k: jnp.asarray(v) for k, v in p.items()}

    def loss(p, x):
        y, aux = jmoe.moe_apply_dense(p, x, cfg)
        return jnp.sum(y * y) + aux, y

    (value, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        p, jnp.asarray(x))
    yd, _ = jax.jit(lambda p, x: jmoe.moe_apply_dense(p, x, cfg))(
        p, jnp.asarray(xd))
    return {"y": np.asarray(y), "loss": float(value),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "y_decode": np.asarray(yd)}


def _moe_rows(out, n_rows):
    d = int(out["moe_data_coord"])
    return slice(d * n_rows, (d + 1) * n_rows)


@pytest.mark.parametrize("name", MOE_JOBS)
def test_moe_ep_ranks_match_jax_dense(app_runs, moe_dense, name):
    """moe_apply_ep on gloo ranks, (2,) and (4,) ("model",) and (2, 2)
    ("data", "model"), Q = 1, against the JAX package's moe_apply_dense on
    the whole input (ample capacity: the same function): the global loss
    within 1e-3 (1 + |loss|) and the gradients within 2e-3 (the JAX
    suite's bounds, tests/test_moe_ep.py), each rank's y within 1e-5 of
    the largest entry."""
    ranks = app_runs(name)
    want = moe_dense
    for out in ranks:
        y = want["y"][_moe_rows(out, out["moe_y_q1"].shape[0])]
        np.testing.assert_allclose(out["moe_y_q1"], y, rtol=0,
                                   atol=1e-5 * np.abs(want["y"]).max())
        loss = float(out["moe_loss_q1"])
        assert abs(loss - want["loss"]) < 1e-3 * (1 + abs(want["loss"]))
        for k, g in want["grads"].items():
            err = np.abs(out[f"moe_grad_{k}_q1"] - g).max()
            assert err < 2e-3, (k, err)


@pytest.mark.parametrize("name", MOE_JOBS)
def test_moe_ep_chunks_are_bit_equal_and_issued_in_order(app_runs, name):
    """a2a_scan with Q = 2 and 4 capacity slices gives y and the loss of
    Q = 1 bit for bit (each slice's FFN is the same rows' products), the
    gradients within 1e-4 of Q = 1's (the weight gradients sum over the
    slices in another order; tests/test_moe_ep.py's bound); every rank's
    issue log is the reference schedule: dispatch(0), then dispatch(k+1)
    before compute(k) and combine(k) before compute(k+1)."""
    for out in app_runs(name):
        for q in MOE["chunks"]:
            np.testing.assert_array_equal(out[f"moe_y_q{q}"], out["moe_y_q1"])
            assert out[f"moe_loss_q{q}"] == out["moe_loss_q1"]
            for k in ("router", "gate", "up", "down"):
                np.testing.assert_allclose(out[f"moe_grad_{k}_q{q}"],
                                           out[f"moe_grad_{k}_q1"], rtol=0,
                                           atol=1e-4)
            want = ["dispatch0"]
            for k in range(q):
                want += ([f"dispatch{k + 1}"] if k + 1 < q else []) + [
                    f"compute{k}", f"combine{k}"]
            assert out[f"moe_log_q{q}"].tolist() == want


@pytest.mark.parametrize("name", MOE_JOBS)
def test_moe_ep_decode_batch_as_tokens(app_runs, moe_dense, name):
    """A decode step (S = 1) through moe_apply on the mesh takes EP with
    the batch swapped into the token slot and equals the dense dispatch
    (tests/test_moe_ep.py's bound, 2e-4)."""
    for out in app_runs(name):
        assert str(out["moe_route_decode"]) == "ep_batch"
        y = moe_dense["y_decode"][_moe_rows(out, out["moe_y_decode"].shape[0])]
        assert np.abs(out["moe_y_decode"] - y).max() < 2e-4


@pytest.mark.parametrize("name", MOE_JOBS)
def test_moe_model_on_a_model_axis_matches_one_rank(app_runs, name):
    """The reduced MoE model (8 experts, top-2, ample capacity, float32)
    built with ModelOptions(mesh=...) takes expert parallelism in every
    MoE block (prefill: tokens along the sequence; decode: the batch as
    tokens; two all-to-alls a block): its prefill and decode logits equal
    the same model's on one rank without a mesh within 1e-4 (the expert
    products group their rows otherwise, so float32 sums round
    otherwise)."""
    from _torch_dist import moe_model_tokens

    from repro_torch.models.model import ModelOptions, build_model

    model = build_model(moe_config(MOE), ModelOptions(attn_impl="flash",
                                                      dtype=torch.float32))
    params = model.init(0, "cpu")
    toks = torch.from_numpy(moe_model_tokens(MOE))
    s = MOE["seq"]
    want, caches = model.prefill(params, {"tokens": toks[:, :s]},
                                 max_len=s + 1)
    step, _ = model.decode_step(params, toks[:, s:], caches, s)
    for out in app_runs(name):
        # dispatch and combine in each of the 4 layers, prefill and decode
        assert int(out["moe_model_a2a_calls"]) == 2 * 4 * 2
        rows = _moe_rows(out, out["moe_model_prefill"].shape[0])
        np.testing.assert_allclose(out["moe_model_prefill"],
                                   want[rows].numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["moe_model_decode"],
                                   step[rows].numpy(), rtol=1e-4, atol=1e-4)


class _StubMesh:
    def __init__(self, **shape):
        self.shape, self.axis_names = shape, tuple(shape)


@pytest.mark.parametrize("n,shape,chunks,match", [
    (3, (2, 12), 1, "num_experts=8 is not divisible"),
    (2, (2, 13), 1, r"token dim \(seq=13\)"),
    (2, (1, 7), 1, r"token dim \(batch=7\)"),
    # n=2, S=32: S/n = 16 tokens, C = ceil(16*2/8 * 1.25) = 5
    (2, (2, 32), 3, "a2a_chunks=3 must be >=1 and divide the expert "
                    "capacity C=5"),
    (2, (2, 32), 0, "a2a_chunks=0")])
def test_moe_ep_rejects_what_does_not_divide(n, shape, chunks, match):
    """The checks that precede any communication, as the JAX package's
    (tests/test_moe_ep.py): experts, tokens and capacity slices that the
    model axis or Q does not divide."""
    from repro_torch.models import moe

    cfg = moe_config(dict(MOE, factor=1.25))
    x = torch.zeros(shape + (cfg.d_model,))
    with pytest.raises(ValueError, match=match):
        moe.moe_apply_ep({}, x, cfg, _StubMesh(model=n),
                         tokens_on_batch="batch" in match, a2a_chunks=chunks)


def test_hierarchical_allreduce_2x2(app_runs):
    """The staged sum equals the plain one within 1e-4; through the int8
    codec within 0.03 relative (tests/test_system.py's bounds) and within
    one quantum of the codec applied by hand; a shape that does not tile
    takes the plain sum; the int16 payload sums exactly."""
    spec = APP_JOBS["2x2"]["allreduce"]
    ranks = app_runs("2x2")
    xs = [app_input(spec, r) for r in range(4)]       # rank = pod * 2 + data
    # by hand: in-pod sum of each half, shared max scale, rounded, summed
    halves = []
    for h in range(2):
        parts = [xs[2 * pod][8 * h:8 * h + 8] + xs[2 * pod + 1][8 * h:8 * h + 8]
                 for pod in range(2)]
        scale = np.float32(max(np.abs(p).max() for p in parts)) / np.float32(
            127.0)
        q = sum(np.clip(np.round(p / scale), -127, 127) for p in parts)
        halves.append((q.astype(np.float32) * (scale * 2 / 2), scale))
    by_hand = np.concatenate([h for h, _ in halves])
    quantum = np.repeat([s for _, s in halves], 8)[:, None]
    q_sum = [sum(np.random.default_rng(r).integers(-127, 128, (33,))
                 for r in pod) for pod in ((0, 2), (1, 3))]
    for r, out in enumerate(ranks):
        plain = out["ar_plain"]
        np.testing.assert_allclose(plain, sum(xs), rtol=1e-5, atol=1e-5)
        assert np.abs(out["ar_staged"] - plain).max() < 1e-4
        rel = np.abs(out["ar_comp"] - plain).max() / (np.abs(plain).max()
                                                      + 1e-9)
        assert rel < 0.03, rel
        assert (np.abs(out["ar_comp"] - by_hand) <= quantum).all()
        np.testing.assert_array_equal(out["ar_odd"], out["ar_odd_plain"])
        np.testing.assert_allclose(out["ar_odd"],
                                   sum(x[:spec["odd_rows"]] for x in xs),
                                   rtol=1e-5, atol=1e-5)
        assert out["int16_sum"].dtype == np.int16
        np.testing.assert_array_equal(out["int16_sum"], q_sum[r % 2])


def test_hierarchical_allreduce_2x2_matches_jax(app_runs):
    """The same four inputs through the JAX package's staged all-reduce on
    four forced host devices: the plain-staged and the tile-less results
    within float32 rounding of the port's, the int8-compressed one within
    one quantum (q may round the other way at a tie, since XLA divides by
    the scale as a multiply by its reciprocal)."""
    spec = APP_JOBS["2x2"]["allreduce"]
    xs = np.stack([app_input(spec, r) for r in range(4)])
    code = f"""
    import json, jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.reduction import hierarchical_allreduce
    from repro.launch.mesh import make_mesh
    from repro.optim.compression import make_crosspod_codec
    mesh = make_mesh((2, 2), ("pod", "data"))
    xs = np.asarray({json.dumps(xs.tolist())}, np.float32)
    comp, decomp = make_crosspod_codec("pod")
    fns = {{"staged": lambda x: hierarchical_allreduce(x, "data", "pod", 0),
           "comp": lambda x: hierarchical_allreduce(x, "data", "pod", 0,
                                                    comp, decomp)}}
    outs = {{}}
    for name, rows in (("staged", xs.shape[1]), ("comp", xs.shape[1]),
                       ("odd", {spec["odd_rows"]})):
        f = jax.jit(jax.shard_map(fns.get(name, fns["staged"]), mesh=mesh,
                                  in_specs=P(("pod", "data")),
                                  out_specs=P(("pod", "data"))))
        y = f(np.concatenate(list(xs[:, :rows])))  # block r: pod r//2, data r%2
        outs[name] = np.asarray(y).reshape(4, rows, -1).tolist()
    print(json.dumps(outs))
    """
    want = {k: np.asarray(v, np.float32)
            for k, v in run_devices(code, 4).items()}
    quantum = np.repeat(
        [max(np.abs(xs[2 * pod, 8 * h:8 * h + 8]
                    + xs[2 * pod + 1, 8 * h:8 * h + 8]).max()
             for pod in range(2)) / np.float32(127.0) for h in range(2)],
        8)[:, None]
    for r, out in enumerate(app_runs("2x2")):
        np.testing.assert_allclose(out["ar_staged"], want["staged"][r],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["ar_odd"], want["odd"][r],
                                   rtol=1e-5, atol=1e-5)
        assert (np.abs(out["ar_comp"] - want["comp"][r])
                <= quantum * (1 + 1e-5)).all()


# --------------------------------------------- gradient sync and training
TRAIN = dict(arch="internlm2-1.8b", steps=3, global_batch=8, seq_len=32,
             lr=5e-3, cases=[["hdot", 1], ["two_phase", 1], ["hdot", 2],
                             ["two_phase", 2]])
# Whisper-base (reduced: 2 encoder and 4 decoder layers, 64 frames) with
# the reference's float32 stub frames
WHISPER_TRAIN = dict(arch="whisper-base", steps=3, global_batch=4,
                     seq_len=16, lr=5e-3,
                     cases=[["hdot", 1], ["two_phase", 1]])
# the recurrent families: reduced Mamba-2 (4 layers, 8 SSD heads of 16,
# state 16, chunk 32: two chunks a sequence) data-parallel, and reduced
# RecurrentGemma-2B (rglru, rglru, attn, rglru) under ZeRO-3, float32
MAMBA_TRAIN = dict(arch="mamba2-780m", steps=3, global_batch=4, seq_len=64,
                   lr=5e-3, cases=[["hdot", 1], ["two_phase", 1]])
RG_ZERO3 = dict(ZERO3, arch="recurrentgemma-2b")
TRAIN_JOBS = {
    "2": dict(mesh=[2], gradsync=dict(mesh=[2], axes=["data"]),
              train=dict(WHISPER_TRAIN, mesh=[2], axes=["data"])),
    "2r": dict(mesh=[2], train=dict(MAMBA_TRAIN, mesh=[2], axes=["data"]),
               zero3=dict(RG_ZERO3, mesh=[2], axes=["data"])),
    "2x2": dict(mesh=[2, 2], gradsync=dict(mesh=[2, 2], axes=["pod", "data"]),
                train=dict(TRAIN, mesh=[2, 2], axes=["pod", "data"])),
}


def _train_state(arch=TRAIN["arch"]):
    """The reduced model's float32 parameters, unrolled (one numpy draw,
    ``tests/_torch_jax.py``), in the port's layout, with zero AdamW state."""
    from _torch_jax import numpy_params

    from repro.config.registry import get_arch as jax_arch
    from repro.models.model import ModelOptions as JaxOptions
    from repro.models.model import build_model as jax_build
    from repro_torch.config.registry import get_arch
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import ModelOptions
    from repro_torch.optim import adamw_init

    tree = numpy_params(jax_build(jax_arch(arch).reduced(),
                                  JaxOptions(dtype=jnp.float32,
                                             scan_layers=False)))
    params = params_from_jax(tree, get_arch(arch).reduced(),
                             ModelOptions(dtype=torch.float32,
                                          scan_layers=False), "cpu")
    return {"params": params, "opt": adamw_init(params)}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """(workdir, per-rank results) of a TRAIN_JOBS job; a job that trains
    starts from the checkpoint written to ``<workdir>/init``."""
    from repro_torch.checkpoint import save_checkpoint

    cache = {}

    def get(name):
        if name not in cache:
            workdir = tmp_path_factory.mktemp(f"train{name}")
            if "train" in TRAIN_JOBS[name]:
                arch = TRAIN_JOBS[name]["train"]["arch"]
                save_checkpoint(str(workdir / "init"), 0, _train_state(arch),
                                extra={"data_step": 0})
            cache[name] = workdir, spawn(TRAIN_JOBS[name], None, workdir,
                                         SPAWN_DEADLINE_S)
        return cache[name]
    return get


@pytest.mark.parametrize(
    "name", [k for k, v in TRAIN_JOBS.items() if "gradsync" in v])
def test_grad_sync_hdot_equals_two_phase_on_ranks(train_runs, name):
    """Integer-valued mixed-dtype gradients (bf16, f32, f16, a scalar)
    summed over (2,) ("data",) and (2, 2) ("pod", "data"): hdot equals
    two_phase bit for bit, equals numpy's sum, keeps every leaf's dtype,
    and the scalar comes back times the rank count."""
    from _torch_dist import sync_tree

    _, ranks = train_runs(name)
    world = len(ranks)
    want = {k: sum(sync_tree(r)[k].float().numpy() for r in range(world))
            for k in ("emb", "w1", "w2", "b")}
    dtypes = {"emb": "torch.bfloat16", "w1": "torch.float32",
              "w2": "torch.float16", "b": "torch.float32"}
    for out in ranks:
        for k in want:
            np.testing.assert_array_equal(out[f"sync_hdot_{k}"],
                                          out[f"sync_two_phase_{k}"])
            np.testing.assert_array_equal(out[f"sync_hdot_{k}"], want[k])
            assert str(out[f"sync_hdot_{k}_dtype"]) == dtypes[k]
        assert float(out["sync_hdot_b"]) == 3.0 * world


def _final_params(ckpt_dir, like):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.layers import tree_leaves

    _, tree, _ = restore_checkpoint(str(ckpt_dir), like)
    return torch.cat([p.reshape(-1) for p in tree_leaves(tree["params"])]
                     ).numpy()


def test_trainer_on_4_ranks_matches_jax_and_one_rank(train_runs):
    """The Trainer on a (2, 2) ("pod", "data") gloo mesh, unrolled, f32,
    3 steps, each rank on its quarter of the global batch, under hdot and
    two_phase with 1 and 2 microbatches: every rank holds the same state;
    hdot matches two_phase; and losses, grad norms and final parameters
    match, at rtol 1e-4, the port on one rank with the global batch, the
    JAX Trainer on a forced 4-device ("data",) mesh (its explicit
    shard_map schedule, in a subprocess) and the JAX Trainer without a
    mesh. The JAX runs restore the port's initial checkpoint."""
    import shutil

    from repro.config.base import ParallelConfig as JaxParallel
    from repro.config.base import RunConfig as JaxRun
    from repro.config.base import TrainConfig as JaxTrain
    from repro.config.registry import get_arch as jax_arch
    from repro.models.model import ModelOptions as JaxOptions
    from repro.runtime.trainer import Trainer as JaxTrainer
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    workdir, ranks = train_runs("2x2")
    spec = TRAIN_JOBS["2x2"]["train"]
    train = dict(global_batch=spec["global_batch"], seq_len=spec["seq_len"],
                 lr=spec["lr"], warmup_steps=2, total_steps=spec["steps"],
                 checkpoint_every=10 ** 6, seed=3)
    code = f"""
    import json, shutil, jax.numpy as jnp
    from repro.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro.config.registry import get_arch
    from repro.launch.mesh import make_mesh
    from repro.models.model import ModelOptions
    from repro.runtime.trainer import Trainer
    out = {{}}
    for accum in (1, 2):
        d = {str(workdir)!r} + f"/jax_mesh{{accum}}"
        shutil.copytree({str(workdir / "init")!r}, d)
        run = RunConfig(model=get_arch({spec["arch"]!r}).reduced(),
                        parallel=ParallelConfig(accum_steps=accum,
                                                remat="none",
                                                scan_layers=False),
                        train=TrainConfig(checkpoint_dir=d, **{train!r}))
        t = Trainer(run, mesh=make_mesh((4,), ("data",)),
                    options=ModelOptions(dtype=jnp.float32,
                                         scan_layers=False))
        t.train({spec["steps"]})
        t.save()
        t.ckpt.wait()
        out[accum] = {{k: [m[k] for m in t.metrics_log]
                      for k in ("loss", "grad_norm")}}
    print(json.dumps(out))
    """
    jax_mesh = run_devices(code, 4)
    like = _train_state()
    refs = {}
    for accum in (1, 2):
        d = workdir / f"jax_none{accum}"
        shutil.copytree(workdir / "init", d)
        jt = JaxTrainer(
            JaxRun(model=jax_arch(spec["arch"]).reduced(),
                   parallel=JaxParallel(accum_steps=accum, remat="none",
                                        scan_layers=False),
                   train=JaxTrain(checkpoint_dir=str(d), **train)),
            options=JaxOptions(dtype=jnp.float32, scan_layers=False))
        jt.train(spec["steps"])
        jt.save()
        jt.ckpt.wait()
        one = Trainer(
            RunConfig(model=get_arch(spec["arch"]).reduced(),
                      parallel=ParallelConfig(accum_steps=accum, remat="none",
                                              scan_layers=False),
                      train=TrainConfig(checkpoint_dir=str(workdir / "init"),
                                        **train)),
            options=ModelOptions(dtype=torch.float32, scan_layers=False),
            device="cpu")
        one.train(spec["steps"])
        refs[accum] = {
            "jax_mesh": (jax_mesh[str(accum)],
                         _final_params(workdir / f"jax_mesh{accum}", like)),
            "jax_none": ({k: [m[k] for m in jt.metrics_log]
                          for k in ("loss", "grad_norm")},
                         _final_params(d, like)),
            "one_rank": ({k: [m[k] for m in one.metrics_log]
                          for k in ("loss", "grad_norm")},
                         torch.cat([p.detach().reshape(-1) for p in
                                    tree_leaves(one.full_params())]).numpy())}
    for overlap, accum in spec["cases"]:
        tag = f"{overlap}{accum}"
        for out in ranks[1:]:
            for key in ("loss", "grad_norm", "params"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
        got = ranks[0]
        for other in ({k: got[f"two_phase{accum}_{k}"]
                       for k in ("loss", "grad_norm")}, *[
                           r[0] for r in refs[accum].values()]):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[f"{tag}_{key}"], other[key],
                                           rtol=1e-4)
        leaves = tree_leaves(like["params"])
        for _, params in refs[accum].values():
            params_close(got[f"{tag}_params"], params, leaves)
        params_close(got[f"{tag}_params"], got[f"two_phase{accum}_params"],
                     leaves)


def test_trainer_ranks_issue_buckets_in_reverse_topological_order(
        train_runs):
    """Every rank's hdot all-reduces, logged by a wrapper of
    dist.all_reduce: each step issues the buckets of
    make_buckets(order="reverse_topo") in emission order, then the loss's
    pmean; with one microbatch the buckets of the head and of layers 4..2
    are issued before the first gradient of layer 1 is ready. The port's
    partition equals the JAX package's on the same model."""
    from repro.config.registry import get_arch as jax_arch
    from repro.core.overlap import make_buckets as jmake_buckets
    from repro.models.model import ModelOptions as JaxOptions
    from repro.models.model import build_model as jax_build

    _, ranks = train_runs("2x2")
    spec = TRAIN_JOBS["2x2"]["train"]
    want = check_issue_order(ranks, spec)
    jm = jax_build(jax_arch(spec["arch"]).reduced(),
                   JaxOptions(scan_layers=False))
    assert want == [[i for i, _ in b] for b in jmake_buckets(
        jm.abstract_params(), 8, jm.param_layers(), "reverse_topo")]
    assert len(want) == 6


def test_whisper_trainer_on_2_ranks_matches_one_rank(train_runs):
    """The encoder-decoder's Trainer on 2 gloo ranks ((2,) ("data",),
    reduced whisper-base, float32, unrolled, the reference's float32 stub
    frames), 3 steps, each rank on its half of the global batch: both
    ranks hold the same state; hdot equals two_phase bit for bit (a sum of
    two); losses, grad norms and final parameters match the port on one
    rank with the global batch at rtol 1e-4. Each step's hdot all-reduces
    are the buckets of make_buckets(order="reverse_topo") in emission
    order, the JAX package's partition, and every bucket of the decoder
    stack (depths above the encoder's) is issued before any bucket of the
    encoder (its backward runs after the decoder's)."""
    from repro.config.registry import get_arch as jax_arch
    from repro.core.overlap import make_buckets as jmake_buckets
    from repro.models.model import ModelOptions as JaxOptions
    from repro.models.model import build_model as jax_build
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.core.overlap import make_buckets
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.trainer import Trainer

    workdir, ranks = train_runs("2")
    spec = TRAIN_JOBS["2"]["train"]
    cfg = get_arch(spec["arch"]).reduced()
    for tag in ("hdot1", "two_phase1"):
        for key in ("loss", "grad_norm", "params"):
            np.testing.assert_array_equal(ranks[1][f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])
            np.testing.assert_array_equal(ranks[0][f"hdot1_{key}"],
                                          ranks[0][f"two_phase1_{key}"])
    one = Trainer(
        RunConfig(model=cfg,
                  parallel=ParallelConfig(remat="none", scan_layers=False),
                  train=TrainConfig(
                      global_batch=spec["global_batch"],
                      seq_len=spec["seq_len"], lr=spec["lr"],
                      warmup_steps=2, total_steps=spec["steps"],
                      checkpoint_every=10 ** 6, seed=3,
                      checkpoint_dir=str(workdir / "init"))),
        options=ModelOptions(dtype=torch.float32, scan_layers=False),
        device="cpu")
    one.train(spec["steps"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][f"hdot1_{key}"],
                                   [m[key] for m in one.metrics_log],
                                   rtol=1e-4)
    like = _train_state(spec["arch"])["params"]
    params_close(ranks[0]["hdot1_params"],
                 torch.cat([p.detach().reshape(-1)
                            for p in tree_leaves(one.params)]).numpy(),
                 tree_leaves(like))

    model = build_model(cfg, ModelOptions(dtype=torch.float32,
                                          scan_layers=False))
    want = [[i for i, _ in b] for b in make_buckets(
        model.init(0, "cpu"), 8, model.param_layers(), "reverse_topo")]
    jm = jax_build(jax_arch(spec["arch"]).reduced(),
                   JaxOptions(scan_layers=False))
    assert want == [[i for i, _ in b] for b in jmake_buckets(
        jm.abstract_params(), 8, jm.param_layers(), "reverse_topo")]
    per_step = list(range(len(want))) + [-1]
    for out in ranks:
        assert json.loads(str(out["hdot1_buckets"])) == want
        assert out["hdot1_issued"].tolist() == per_step * spec["steps"]
    depth = tree_leaves(model.param_layers())
    enc_top = cfg.encdec.enc_layers + 1               # enc_norm's depth
    decoder = [k for k, b in enumerate(want)
               if any(depth[i] > enc_top for i in b)]
    encoder = [k for k, b in enumerate(want)
               if any(1 <= depth[i] <= enc_top for i in b)]
    assert decoder and encoder and max(decoder) < min(encoder), (
        [sorted({depth[i] for i in b}) for b in want])


def test_mamba2_trainer_on_2_ranks_matches_one_rank(train_runs):
    """The ssm family's Trainer on 2 gloo ranks ((2,) ("data",), reduced
    mamba2-780m, float32, unrolled), 3 steps, each rank on its half of the
    global batch: both ranks hold the same state; hdot equals two_phase
    bit for bit; losses, grad norms and final parameters match the port on
    one rank with the global batch at rtol 1e-4. Each step's hdot
    all-reduces are the buckets of make_buckets(order="reverse_topo") in
    emission order, the JAX package's partition (the layer depths of the
    Mamba-2 blocks), the buckets deeper than layer 1 issued before layer
    1's first gradient is ready."""
    from repro.config.registry import get_arch as jax_arch
    from repro.core.overlap import make_buckets as jmake_buckets
    from repro.models.model import ModelOptions as JaxOptions
    from repro.models.model import build_model as jax_build
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    workdir, ranks = train_runs("2r")
    spec = TRAIN_JOBS["2r"]["train"]
    for key in ("loss", "grad_norm", "params"):
        for tag in ("hdot1", "two_phase1"):
            np.testing.assert_array_equal(ranks[1][f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])
        np.testing.assert_array_equal(ranks[0][f"hdot1_{key}"],
                                      ranks[0][f"two_phase1_{key}"])
    one = Trainer(
        RunConfig(model=get_arch(spec["arch"]).reduced(),
                  parallel=ParallelConfig(remat="none", scan_layers=False),
                  train=TrainConfig(
                      global_batch=spec["global_batch"],
                      seq_len=spec["seq_len"], lr=spec["lr"],
                      warmup_steps=2, total_steps=spec["steps"],
                      checkpoint_every=10 ** 6, seed=3,
                      checkpoint_dir=str(workdir / "init"))),
        options=ModelOptions(dtype=torch.float32, scan_layers=False),
        device="cpu")
    one.train(spec["steps"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][f"hdot1_{key}"],
                                   [m[key] for m in one.metrics_log],
                                   rtol=1e-4)
    params_close(ranks[0]["hdot1_params"],
                 torch.cat([p.detach().reshape(-1)
                            for p in tree_leaves(one.params)]).numpy(),
                 tree_leaves(_train_state(spec["arch"])["params"]))
    want = check_issue_order(ranks, spec)
    jm = jax_build(jax_arch(spec["arch"]).reduced(),
                   JaxOptions(scan_layers=False))
    assert want == [[i for i, _ in b] for b in jmake_buckets(
        jm.abstract_params(), 8, jm.param_layers(), "reverse_topo")]


def test_recurrentgemma_zero3_on_2_ranks(train_runs):
    """The hybrid family under ZeRO-3 on 2 gloo ranks (reduced
    recurrentgemma-2b, float32, unrolled, remat "full", the unfused loss,
    3 steps): both ranks report the same losses, grad norms and full
    parameters. Streaming (each layer's bucket gathered inside its remat
    region, regathered in the backward) equals gathering all bit for bit
    in every bucket's first-step gradient (the AdamW moments after step 1)
    except the tied embedding's: streaming gathers depth 0 twice, for the
    lookup and for the head, as the reference's ``materialize(pflat,
    *head_depths)`` does, and sums the two reduce-scatters, where gathering
    all reduce-scatters the sum (ROADMAP.md Queue 3); that bucket is within
    1e-6 of its largest entry. After 3 steps both match the replicated
    trainer on one rank with the global batch (losses and grad norms at
    rtol 1e-5, parameters within 1e-4 of each leaf's largest entry)."""
    from _torch_dist import zero3_trainer

    from repro_torch.models.layers import tree_leaves

    _, ranks = train_runs("2r")
    for tag in ("z3stream", "z3gather"):
        for key in ("loss", "grad_norm", "params"):
            np.testing.assert_array_equal(ranks[1][f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])
    for out in ranks:
        keys = [str(k) for k in out["z3stream_keys"]]
        assert keys == [str(k) for k in out["z3gather_keys"]]
        tied = keys.index(next(k for k in keys if k.startswith("b00_")))
        bounds = np.cumsum([0] + out["z3stream_shard_sizes"].tolist())
        for name in ("m1", "v1"):
            got, want = (out[f"z3{c}_shard_{name}"]
                         for c in ("stream", "gather"))
            for i in range(len(keys)):
                a, b = (v[bounds[i]:bounds[i + 1]] for v in (got, want))
                if i == tied:
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=1e-6 * np.abs(b).max())
                else:
                    np.testing.assert_array_equal(a, b)
    one = zero3_trainer(RG_ZERO3, "repl", None, "cpu")
    one.init_state(seed=0)
    one.train(RG_ZERO3["steps"])
    flat = torch.cat([p.detach().reshape(-1)
                      for p in tree_leaves(one.params)]).numpy()
    for tag in ("z3stream", "z3gather"):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       [m[key] for m in one.metrics_log],
                                       rtol=1e-5)
        params_close(ranks[0][f"{tag}_params"], flat,
                     tree_leaves(one.params))


# ------------------------------------------------------------------ ZeRO-3
@pytest.fixture(scope="module")
def zero3_one_rank():
    """The replicated trainer on one rank with the ZeRO-3 job's model,
    options, seed and global batch, trained: (its metrics, its parameters
    flattened in tree order, their leaves, the trainer)."""
    from _torch_dist import zero3_trainer

    from repro_torch.models.layers import tree_leaves

    t = zero3_trainer(ZERO3, "repl", None, "cpu")
    t.init_state(seed=0)
    t.train(ZERO3["steps"])
    metrics = {k: np.array([m[k] for m in t.metrics_log])
               for k in ("loss", "grad_norm")}
    flat = torch.cat([p.detach().reshape(-1) for p in
                      tree_leaves(t.params)]).numpy()
    return metrics, flat, tree_leaves(t.params), t


@pytest.mark.parametrize("name", ZERO3_JOBS)
def test_zero3_ranks_match_the_replicated_trainer(app_runs, zero3_one_rank,
                                                  name):
    """ZeRO-3 (gathering all and streaming) on (2,), (4,) and (2, 2)
    ("pod", "data") gloo ranks, reduced qwen3-8b in float32, 3 steps,
    each rank on its slice of the global batch: every rank reports the
    same losses, grad norms (the clip norm all-reduced over the DP group)
    and full parameters; the losses and grad norms match the replicated
    trainer on one rank with the global batch within rtol 1e-5, the
    parameters within 1e-4 of each leaf's largest entry, the tolerance of
    the replicated trainer's own ranks-vs-one-rank test (the global mean
    gradient is summed in another order, and AdamW turns a last-bit
    gradient difference on an entry whose second moment is at the
    rounding scale into a larger step: on 2 ranks one embedding entry
    of 32768 moves 4.2e-6, 1.2e-5 of the leaf's largest)."""
    metrics, flat, leaves, _ = zero3_one_rank
    ranks = app_runs(name)
    for case in ZERO3["cases"]:
        tag = f"z3{case}"
        for out in ranks[1:]:
            for key in ("loss", "grad_norm", "params"):
                np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0][f"{tag}_{key}"],
                                       metrics[key], rtol=1e-5)
        params_close(ranks[0][f"{tag}_params"], flat, leaves)


@pytest.mark.parametrize("name", ZERO3_JOBS)
def test_zero3_streaming_bit_equal_to_gather_all_on_ranks(app_runs, name):
    """On every rank streaming and gathering all give the same losses,
    grad norms, full parameters and shards of params and both moments,
    bit for bit."""
    for out in app_runs(name):
        for key in ("loss", "grad_norm", "params", "shard_p", "shard_m",
                    "shard_v"):
            np.testing.assert_array_equal(out[f"z3stream_{key}"],
                                          out[f"z3gather_{key}"])


@pytest.mark.parametrize("name", ZERO3_JOBS)
def test_zero3_ranks_hold_their_shards_and_issue_the_schedule(
        app_runs, zero3_one_rank, name):
    """Each of the n ranks holds padded / n elements of every buffer (rank
    r the r-th slice, drawn bucket by bucket: bit-equal to the full
    init's buffers cut), the padding of params and moments is zero after
    3 steps, and the logged collectives follow the schedule
    (check_zero3_log: gathers forward, reduce-scatters in reverse layout
    order, streaming's backward regathers in reverse depth order with at
    most 2 buckets gathered at once)."""
    from repro_torch.core.overlap import fsdp_layout, fsdp_shard_full

    model = zero3_one_rank[3].model
    ranks = app_runs(name)
    n = len(ranks)
    layout = fsdp_layout(model.param_specs(), n, 8, model.param_layers(),
                         "layer")
    full = fsdp_shard_full(model.init(0, "cpu"), layout)
    for r, out in enumerate(ranks):
        for case in ZERO3["cases"]:
            tag = f"z3{case}"
            assert [str(k) for k in out[f"{tag}_keys"]] == list(layout.keys)
            assert (out[f"{tag}_shard_sizes"] * n
                    == out[f"{tag}_padded"]).all()
            assert bool(out[f"{tag}_pad_zero"])
            check_zero3_log(out[f"{tag}_log"], layout.keys,
                            case == "stream", ZERO3["steps"])
            want = torch.cat([full[k].reshape(n, -1)[r] for k in layout.keys])
            np.testing.assert_array_equal(out[f"{tag}_init"], want.numpy())


# ----------------------------------------------------- TP rings and decode
@pytest.fixture(scope="module")
def jax_tp():
    """The JAX package on 4 forced host devices (one subprocess): ag_matmul
    and matmul_rs of every RING_CASES case on (2,), (3,) and (4,) rings
    (the global outputs), and its build_decode_step's teacher-forced
    logits on the (1, 4) and (2, 2) ("data", "model") meshes in both modes,
    on the port's parameters of the TP job (its init, exported with numpy)
    and the same admitted caches."""
    repo = Path(__file__).resolve().parents[1]
    code = f"""
    import dataclasses, functools, json, sys
    sys.path.insert(0, {str(repo / "tests")!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.config.registry import get_arch
    from repro.core.collective_matmul import ag_matmul, matmul_rs
    from repro.launch.mesh import make_mesh
    from repro.models.decode_tp import build_decode_step
    from repro.models.model import ModelOptions, build_model
    from repro.runtime.server import (_mark_prefill_tail, _scatter_slot,
                                      make_slot_caches)
    from _torch_dist import (RING_CASES, TP_PROMPTS, ring_input, tp_fields,
                             tp_model)
    from repro_torch.models.layers import tree_map

    ring, tp = {RING!r}, {TP!r}
    out = {{}}
    for n in (2, 3, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
        x, w, h, v = ring_input(ring, n)
        for mode, chunks in RING_CASES:
            for name, fn, a, b, specs, ospec in (
                    ("ag", ag_matmul, x, w, (P("model", None), P(None, "model")),
                     P(None, "model")),
                    ("rs", matmul_rs, h, v, (P(None, "model"), P("model", None)),
                     P("model", None))):
                f = jax.jit(jax.shard_map(
                    functools.partial(fn, axis_name="model", mode=mode,
                                      chunks=chunks),
                    mesh=mesh, in_specs=specs, out_specs=ospec))
                out[f"ring_{{name}}_{{n}}_{{mode}}_{{chunks}}"] = np.asarray(
                    f(a, b)).tolist()
    tmodel, tparams = tp_model(tp, "cpu")
    params = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tparams))
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), **tp_fields(tp))
    model = build_model(cfg, ModelOptions(attn_impl="dense",
                                          dtype=jnp.float32))
    slots, max_len = tp["slots"], tp["max_len"]
    caches = make_slot_caches(model, slots, max_len)
    for i, p in enumerate(TP_PROMPTS[:slots]):
        _, pc = model.prefill(params, {{"tokens": jnp.asarray([p])}},
                              max_len=max_len)
        caches = _scatter_slot(caches, _mark_prefill_tail(pc, len(p)), i,
                               slots)
    token = jnp.asarray([[7 + i] for i in range(slots)])
    pos = jnp.asarray([len(p) for p in TP_PROMPTS[:slots]])
    for shape in ((1, 4), (2, 2)):
        for mode in ("hdot", "two_phase"):
            step = build_decode_step(model, make_mesh(shape, ("data", "model")),
                                     mode=mode)
            logits, _ = jax.jit(step)(params, token, caches, pos)
            out[f"tp_{{shape[0]}}x{{shape[1]}}_{{mode}}"] = np.asarray(
                logits).tolist()
    print(json.dumps(out))
    """
    return {k: np.asarray(v, np.float32)
            for k, v in run_devices(code, 4).items()}


def _ring_blocks(n: int, r: int):
    return (slice(r * RING["rows"], (r + 1) * RING["rows"]),
            slice(r * RING["cols"], (r + 1) * RING["cols"]))


@pytest.mark.parametrize("name", RING_JOBS)
def test_tp_rings_match_numpy_and_count_sends(app_runs, name):
    """ag_matmul and matmul_rs on (2,), (3,) and (4,) gloo rings, 15 rows
    a rank, both modes, chunks None, 1 and 3: every rank's output within
    rtol 1e-4 of numpy's x @ w (the JAX suite's bound), hdot within 1e-5
    of two_phase, and each hdot call sent ring_permute_count messages
    (two_phase none)."""
    from repro_torch.core.collective_matmul import ring_permute_count

    ranks = app_runs(name)
    n = len(ranks)
    x, w, h, v = ring_input(RING, n)
    for r, out in enumerate(ranks):
        rb, cb = _ring_blocks(n, r)
        want = {"ag": (x @ w)[:, cb], "rs": (h @ v)[rb]}
        for mode, chunks in RING_CASES:
            sends = (ring_permute_count(RING["rows"], n, chunks=chunks)
                     if mode == "hdot" else 0)
            assert sends == 0 or sends >= n - 1
            for op in ("ag", "rs"):
                got = out[f"ring_{op}_{mode}_{chunks}"]
                np.testing.assert_allclose(got, want[op], rtol=1e-4,
                                           atol=1e-4)
                np.testing.assert_allclose(
                    got, out[f"ring_{op}_two_phase_None"], rtol=1e-5,
                    atol=1e-5)
                assert int(out[f"ring_{op}_{mode}_{chunks}_sends"]) == sends


@pytest.mark.parametrize("name", RING_JOBS)
def test_tp_rings_match_jax(app_runs, jax_tp, name):
    """The same inputs through the JAX package's rings on n forced host
    devices: every rank's block within rtol 1e-5."""
    ranks = app_runs(name)
    n = len(ranks)
    for r, out in enumerate(ranks):
        rb, cb = _ring_blocks(n, r)
        for mode, chunks in RING_CASES:
            want = jax_tp[f"ring_ag_{n}_{mode}_{chunks}"][:, cb]
            np.testing.assert_allclose(out[f"ring_ag_{mode}_{chunks}"], want,
                                       rtol=1e-5, atol=1e-5)
            want = jax_tp[f"ring_rs_{n}_{mode}_{chunks}"][rb]
            np.testing.assert_allclose(out[f"ring_rs_{mode}_{chunks}"], want,
                                       rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tp_one_rank():
    """The TP job on one rank, the port's plain path: the served tokens,
    the teacher-forced step's logits (model.decode_step), and the JAX
    BatchServer's tokens on the same parameters."""
    from repro.config.registry import get_arch as jax_arch
    from repro.models.model import ModelOptions as JaxOptions
    from repro.models.model import build_model as jax_build
    from repro.runtime.server import BatchServer as JaxServer
    from repro.runtime.server import Request as JaxRequest
    from _torch_dist import TP_MAX_NEW, tp_fields

    from repro_torch.models.layers import tree_map

    model, params = tp_model(TP, "cpu")
    tokens, stats = tp_serve(model, params, TP)
    logits, _ = model.decode_step(params, *tp_admitted(model, params, TP,
                                                       "cpu"))
    jm = jax_build(dataclasses.replace(jax_arch("qwen3-8b").reduced(),
                                       **tp_fields(TP)),
                   JaxOptions(attn_impl="dense", dtype=jnp.float32))
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params))
    srv = JaxServer(jm, jp, slots=TP["slots"], max_len=TP["max_len"])
    for p, m in zip(TP_PROMPTS, TP_MAX_NEW):
        srv.submit(JaxRequest(prompt=list(p), max_new_tokens=m))
    jax_tokens = np.full_like(tokens, -1)
    for r in srv.run_continuous():
        jax_tokens[r.rid, :len(r.output)] = r.output
    return {"tokens": tokens, "stats": stats, "logits": logits.numpy(),
            "jax_tokens": jax_tokens, "cfg": model.cfg}


def _tp_mesh(name):
    dp, tp = APP_JOBS[name]["tp_decode"]["mesh"]
    return dp, tp


@pytest.mark.parametrize("name", TP_JOBS)
def test_tp_decode_serves_the_one_rank_and_jax_tokens(app_runs, tp_one_rank,
                                                      name):
    """run_continuous with the TP step on (1, 4) and (2, 2) ("data",
    "model") gloo ranks, both modes, reduced qwen3-8b in float32 (6
    requests through 4 slots, with refills): every rank serves the port's
    one-rank tokens and the JAX BatchServer's, token for token, and sends
    expected_permute_total messages a decode step (two_phase none)."""
    from repro_torch.models.decode_tp import expected_permute_total

    dp, tp = _tp_mesh(name)
    per_step = expected_permute_total(tp_one_rank["cfg"], TP["slots"], dp, tp)
    assert per_step == (4 * TP["layers"] + 1) * (tp - 1)
    np.testing.assert_array_equal(tp_one_rank["tokens"],
                                  tp_one_rank["jax_tokens"])
    for out in app_runs(name):
        for mode in ("hdot", "two_phase"):
            np.testing.assert_array_equal(out[f"tp_{mode}_tokens"],
                                          tp_one_rank["tokens"])
            steps = int(out[f"tp_{mode}_decode_steps"])
            assert steps == tp_one_rank["stats"]["decode_steps"]
            assert int(out[f"tp_{mode}_sends"]) == (
                per_step * steps if mode == "hdot" else 0)


@pytest.mark.parametrize("name", TP_JOBS)
def test_tp_decode_step_matches_jax_build_decode_step(app_runs, jax_tp,
                                                      tp_one_rank, name):
    """One teacher-forced step after identical admissions: every rank's
    logits (all slots, gathered over "data") within rtol 1e-5, atol 1e-5
    of the JAX build_decode_step's on the same mesh shape and mode (4
    forced host devices), and of model.decode_step on one rank; the step
    sent expected_permute_total messages (two_phase none)."""
    from repro_torch.models.decode_tp import expected_permute_total

    dp, tp = _tp_mesh(name)
    for out in app_runs(name):
        for mode in ("hdot", "two_phase"):
            got = out[f"tp_{mode}_logits"]
            assert got.shape == (TP["slots"], 1,
                                 tp_one_rank["cfg"].vocab_size)
            np.testing.assert_allclose(got, jax_tp[f"tp_{dp}x{tp}_{mode}"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, tp_one_rank["logits"],
                                       rtol=1e-5, atol=1e-5)
            assert int(out[f"tp_{mode}_step_sends"]) == (
                expected_permute_total(tp_one_rank["cfg"], TP["slots"], dp,
                                       tp) if mode == "hdot" else 0)
