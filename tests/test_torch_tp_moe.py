"""Tensor-parallel training of the MoE family with expert parallelism, the
chunked all-to-alls (``moe_a2a_chunks``) in training and serving, remat
"dots" and blockwise attention, against the JAX package.

(a) Reduced Qwen3-30B-A3B (4 experts, top 2) trains on gloo ("data",
"model") meshes (1, 2), (2, 2), (1, 4) and ("pod", "data", "model") (2,
1, 2), at ``moe_a2a_chunks`` Q = 1 and 2, remat "none", "full" and "dots",
float32, for 3 steps, with an ample capacity factor (E / K = 2: an expert
can take every token of a block, so the expert-parallel dispatch drops
nothing and is the dense one): losses, grad norms and parameters match
the JAX Trainer without a mesh at rtol 1e-4 (parameters loaded through
``params_from_jax`` from one numpy draw), every rank reports the same,
and each rank's blocks are bit-equal to the slices of the one-rank tree.
(b) With drops (capacity factor 1.0) the port on gloo (1, 4) matches the
JAX Trainer on a forced 4-device ("data", "model") mesh (its
``moe_apply_ep`` under ``shard_map``, in a subprocess) at rtol 1e-4, Q = 1
and 2. (c) Q = 2 gives Q = 1's forward bit for bit; the expert weights'
gradients are summed slice by slice, so parameters differ by rounding
(as in the JAX package, whose grad norms differ so too); every rank logs
the same all-to-alls, forward and backward, in one order. (d) The serving
cells (``build_cell``, ``cell_step``) with Q = 2 issue 2Q all-to-alls a
MoE layer and give Q = 1's logits bit for bit. (e) Blockwise attention
against the JAX package's. (f) Remat "dots" gives "full"'s losses and
gradients bit for bit, keeps exactly the projections' outputs, and
matches the JAX Trainer's "dots" run.

Each spawn (``tests/_torch_dist.py``) has one deadline, so a hung
collective fails the test instead of hanging it.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import (CASE_OVERRIDES, case_cfg, flat, params_close_tiny_v,
                         spawn, tp_init_key, tp_run)
from _torch_jax import numpy_params
from _torch_serve import case_cfg as serve_case_cfg
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.models.attention import sdpa as jax_sdpa
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config.base import ParallelConfig
from repro_torch.config.registry import get_arch
from repro_torch.config.shapes import ShapeConfig
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.steps import build_cell, check_ported
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.optim import adamw_init
from repro_torch.runtime.trainer import Trainer
from tests.test_system import run_devices

SPAWN_DEADLINE_S = 180
SPEC = dict(steps=3, global_batch=8, seq_len=16, lr=5e-3, total_steps=6)
A = "qwen3-moe-30b-a3b"
LAYERS = 4          # the reduced config's
AMPLE = 2.0         # E / K of the reduced config


def _case(tag, chunks, remat="none", accum=1, scan=False, capacity=AMPLE,
          log=False):
    return dict(tag=tag, arch=A, accum=accum, scan=scan, remat=remat,
                capacity=capacity, chunks=chunks, log=log, moments=True)


JOBS = {
    "1x2": dict(mesh=[1, 2], axes=["data", "model"], cases=[
        _case("q1", 1, log=True), _case("q2", 2, log=True),
        _case("d2", 2, "dots"), _case("a1", 1, "full", accum=2)]),
    "2x2": dict(mesh=[2, 2], axes=["data", "model"], cases=[
        _case("s1", 1, "full", scan=True), _case("f2", 2, "full", log=True),
        _case("d2", 2, "dots", log=True)]),
    "1x4": dict(mesh=[1, 4], axes=["data", "model"], cases=[
        _case("d1", 1, "dots"), _case("q2", 2, log=True),
        _case("x1", 1, capacity=1.0, log=True),
        _case("x2", 2, capacity=1.0, log=True)]),
    "2x1x2": dict(mesh=[2, 1, 2], axes=["pod", "data", "model"], cases=[
        _case("f2", 2, "full", accum=2), _case("d1", 1, "dots")]),
}
AMPLE_CASES = [(job, c["tag"]) for job, spec in JOBS.items()
               for c in spec["cases"] if c["capacity"] == AMPLE]
DROPS = ("1x4", ("x1", "x2"))
# (job, Q = 1 case, Q = 2 case) with everything else the same
Q_PAIRS = [("1x2", "q1", "q2"), ("1x4", "x1", "x2")]


def _find(job, tag):
    return next(c for c in JOBS[job]["cases"] if c["tag"] == tag)


def _cfgs(case):
    jcfg = case_cfg(jax_arch(case["arch"]).reduced(), case)
    run, opts = tp_run(SPEC, case, "unused")
    return jcfg, run, opts


def _numpy_tree(case):
    """The case's float32 parameters, drawn unrolled with numpy."""
    jcfg, _, _ = _cfgs(case)
    return numpy_params(jax_build(jcfg, JaxOptions(dtype=jnp.float32,
                                                   scan_layers=False)))


def _port_params(tree, case):
    _, run, opts = _cfgs(case)
    return params_from_jax(tree, run.model, opts, "cpu")


def _jax_trainer(case, remat="none"):
    jcfg, _, _ = _cfgs(case)
    return JaxTrainer(
        JaxRun(model=jcfg,
               parallel=JaxParallel(accum_steps=case["accum"], remat=remat,
                                    scan_layers=False),
               train=JaxTrain(warmup_steps=2, total_steps=SPEC["total_steps"],
                              checkpoint_every=10 ** 6, seed=3,
                              global_batch=SPEC["global_batch"],
                              seq_len=SPEC["seq_len"], lr=SPEC["lr"])),
        options=JaxOptions(dtype=jnp.float32, scan_layers=False,
                           remat=remat))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX Trainer (no mesh, unrolled, float32) of each (arch, accum,
    capacity, remat): losses, grad norms, final numpy parameters and
    AdamW second moments."""
    cache = {}

    def get(case, remat="none"):
        key = (case["arch"], case["accum"], remat,
               *(case.get(k) for k in CASE_OVERRIDES))
        if key not in cache:
            jt = _jax_trainer(case, remat)
            jt.init_state()
            jt.params = jax.tree.map(jnp.asarray, _numpy_tree(case))
            jt.opt_state = jadamw_init(jt.params)
            jt.train(SPEC["steps"])
            cache[key] = ({k: [m[k] for m in jt.metrics_log]
                           for k in ("loss", "grad_norm", "lr")},
                          jax.tree.map(np.asarray, jt.params),
                          jax.tree.map(np.asarray, jt.opt_state["v"]))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """(workdir, per-rank results) of a JOBS job; each case's initial
    checkpoint is written to ``<workdir>/init_<key>`` first."""
    cache = {}

    def get(name):
        if name not in cache:
            workdir = tmp_path_factory.mktemp(f"moe{name}")
            spec = dict(SPEC, **JOBS[name])
            for case in spec["cases"]:
                d = workdir / f"init_{tp_init_key(case)}"
                if not d.exists():
                    p = _port_params(_numpy_tree(case), case)
                    save_checkpoint(str(d), 0, {"params": p,
                                                "opt": adamw_init(p)},
                                    extra={"data_step": 0})
            cache[name] = workdir, spawn(dict(mesh=spec["mesh"],
                                              tp_train=spec),
                                         None, workdir, SPAWN_DEADLINE_S)
        return cache[name]
    return get


def _close(got, case, want, jparams, jv):
    """The port's final parameters `got` against the JAX run's, by the
    tiny-second-moment rule (:func:`params_close_tiny_v`): embedding rows
    of rare tokens keep AdamW moments of ~1e-15, where rounding decides
    the step."""
    final = _port_params(jparams, case)
    params_close_tiny_v(got, flat(final), tree_leaves(final),
                        flat(_port_params(jv, case)), sum(want["lr"]))


def _ranks_agree(ranks, tag):
    for out in ranks[1:]:
        for key in ("loss", "grad_norm", "lr", "params"):
            np.testing.assert_array_equal(out[f"{tag}_{key}"],
                                          ranks[0][f"{tag}_{key}"])


# ------------------------------------------- (a) against JAX, no drops
@pytest.mark.parametrize("job,tag", AMPLE_CASES)
def test_tp_moe_trainer_matches_jax(tp_runs, jax_runs, job, tag):
    """3 steps of the TP trainer from the JAX parameters, the experts over
    the "model" axis: every rank reports the same losses, grad norms and
    full parameters, and they match the JAX Trainer without a mesh at
    rtol 1e-4 (parameters leaf by leaf, relative to each leaf's largest
    entry). The aux loss is in the loss: counted once a model line."""
    _, ranks = tp_runs(job)
    case = _find(job, tag)
    _ranks_agree(ranks, tag)
    want, jparams, jv = jax_runs(case)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{tag}_{key}"], want[key],
                                   rtol=1e-4)
    _close(ranks[0][f"{tag}_params"], case, want, jparams, jv)


def _slices(tree, index_json) -> np.ndarray:
    index = json.loads(str(index_json))
    parts = [leaf.detach()[tuple(slice(a, b) for a, b in ix)].reshape(-1)
             for leaf, ix in zip(tree_leaves(tree), index)]
    return torch.cat(parts).float().numpy()


@pytest.mark.parametrize("job", list(JOBS))
def test_tp_moe_ranks_hold_their_blocks(tp_runs, job):
    """Each rank's blocks as restored are bit-equal to its slices of the
    one-rank tree; the expert leaves are cut along the experts (each rank
    holds E / tp of them; their "embed" dim FSDP over the DP axes), so no
    rank holds the whole tree."""
    _, ranks = tp_runs(job)
    for case in JOBS[job]["cases"]:
        tag = case["tag"]
        full = _port_params(_numpy_tree(case), case)
        tp = JOBS[job]["mesh"][-1]
        experts = get_arch(A).reduced().moe.num_experts
        for out in ranks:
            np.testing.assert_array_equal(
                out[f"{tag}_blocks0"], _slices(full, out[f"{tag}_index"]))
            index = json.loads(str(out[f"{tag}_index"]))
            for path, ix in zip(leaf_paths(full), index):
                if path[-2:-1] == ("moe",) and path[-1] != "router":
                    a, b = ix[-3]
                    assert b - a == experts // tp
        assert max(len(o[f"{tag}_blocks0"]) for o in ranks) < sum(
            p.numel() for p in tree_leaves(full))


# ----------------------------------- (b) with drops, JAX on 4 devices
@pytest.fixture(scope="module")
def jax_mesh_drops(tmp_path_factory):
    """The JAX Trainer on a forced 4-device ("data", "model") (1, 4) mesh,
    capacity factor 1.0, Q = 1 and 2, from the cases' numpy parameters:
    {Q: (metrics, final numpy parameters, AdamW second moments)}."""
    workdir = tmp_path_factory.mktemp("jaxdrops")
    case = _find(DROPS[0], DROPS[1][0])
    with open(workdir / "tree.pkl", "wb") as f:
        pickle.dump(_numpy_tree(case), f)
    train = dict(global_batch=SPEC["global_batch"], seq_len=SPEC["seq_len"],
                 lr=SPEC["lr"], warmup_steps=2,
                 total_steps=SPEC["total_steps"], checkpoint_every=10 ** 6,
                 seed=3)
    code = f"""
    import dataclasses, json, pickle, jax, jax.numpy as jnp
    from repro.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro.config.registry import get_arch
    from repro.launch.mesh import make_mesh
    from repro.models.model import ModelOptions
    from repro.optim import adamw_init
    from repro.runtime.trainer import Trainer
    cfg = get_arch({A!r}).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    tree = pickle.load(open({str(workdir / "tree.pkl")!r}, "rb"))
    out = {{}}
    for q in (1, 2):
        run = RunConfig(model=cfg,
                        parallel=ParallelConfig(remat="none",
                                                scan_layers=False,
                                                moe_a2a_chunks=q),
                        train=TrainConfig(checkpoint_dir={str(workdir)!r}
                                          + f"/ck{{q}}", **{train!r}))
        t = Trainer(run, mesh=make_mesh((1, 4), ("data", "model")),
                    options=ModelOptions(dtype=jnp.float32,
                                         scan_layers=False,
                                         moe_a2a_chunks=q))
        t.init_state()
        t.params = jax.tree.map(
            lambda a, b: jax.device_put(jnp.asarray(a), b.sharding),
            tree, t.params)
        t.opt_state = adamw_init(t.params)
        t.train({SPEC["steps"]})
        out[q] = {{k: [m[k] for m in t.metrics_log]
                  for k in ("loss", "grad_norm", "lr")}}
        with open({str(workdir)!r} + f"/final{{q}}.pkl", "wb") as f:
            pickle.dump(jax.device_get((t.params, t.opt_state["v"])), f)
    print(json.dumps(out))
    """
    metrics = run_devices(code, 4)
    out = {}
    for q in (1, 2):
        with open(workdir / f"final{q}.pkl", "rb") as f:
            out[q] = (metrics[str(q)], *pickle.load(f))
    return out


@pytest.mark.parametrize("tag", DROPS[1])
def test_tp_moe_with_drops_matches_jax_on_four_devices(tp_runs,
                                                       jax_mesh_drops, tag):
    """Capacity factor 1.0: each rank's block of 4 tokens a sequence keeps
    C = 2 slots an expert, so tokens are dropped; the dispatch is then
    the reference's expert parallelism, not its dense one. The port on
    gloo (1, 4) matches the JAX Trainer on a forced 4-device (1, 4) mesh
    at rtol 1e-4, at the same Q."""
    job = DROPS[0]
    _, ranks = tp_runs(job)
    case = _find(job, tag)
    _ranks_agree(ranks, tag)
    want, jparams, jv = jax_mesh_drops[case["chunks"]]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{tag}_{key}"], want[key],
                                   rtol=1e-4)
    _close(ranks[0][f"{tag}_params"], case, want, jparams, jv)


# --------------------------------------------- (c) Q = 2 against Q = 1
def _a2a_log(out, tag):
    return [tuple(e) for e in json.loads(str(out[f"{tag}_a2a"]))]


@pytest.mark.parametrize("job,q1,q2", Q_PAIRS)
def test_a2a_chunks_keep_the_forward_and_log_one_order(tp_runs, job, q1,
                                                       q2):
    """Q = 2 against Q = 1 on the same mesh and data: the first step's
    loss (the forward) is bit-equal; the expert weights' gradients are
    summed slice by slice, so after 3 steps the losses, grad norms and
    parameters agree to float32 rounding (rtol 1e-6; parameters by the
    tiny-second-moment rule of :func:`_close`). Each rank logs the
    same all-to-alls, forward and backward, and each step issues, a MoE
    layer, the Q dispatches and Q combines forward, then in the backward
    the combines' gradients from slice Q-1 down, then the dispatches'."""
    _, ranks = tp_runs(job)
    a, b = ranks[0], ranks[0]
    assert a[f"{q1}_loss"][0] == b[f"{q2}_loss"][0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(a[f"{q2}_{key}"], a[f"{q1}_{key}"],
                                   rtol=1e-6)
    case = _find(job, q1)
    full = _port_params(_numpy_tree(case), case)
    params_close_tiny_v(a[f"{q2}_params"], a[f"{q1}_params"],
                        tree_leaves(full), a[f"{q1}_v"],
                        SPEC["lr"] * SPEC["steps"], rtol=1e-6)
    for tag, q in ((q1, 1), (q2, 2)):
        logs = [_a2a_log(out, tag) for out in ranks]
        assert all(log == logs[0] for log in logs[1:])
        fwd = [e for k in range(q) for e in
               ([("dispatch", 0)] if k == 0 else [])
               + ([("dispatch", k + 1)] if k + 1 < q else [])
               + [("compute", k), ("combine", k)]]
        bwd = ([("combine_bwd", k) for k in reversed(range(q))]
               + [("dispatch_bwd", k) for k in reversed(range(q))])
        assert logs[0] == (fwd * LAYERS + bwd * LAYERS) * SPEC["steps"]


def test_remat_reissues_the_all_to_alls_in_the_recompute(tp_runs):
    """Under remat "full" and "dots" on (2, 2) every layer's recompute
    issues its forward all-to-alls again in the backward, last layer
    first, each before that layer's backward all-to-alls; the ranks log
    the same order."""
    _, ranks = tp_runs("2x2")
    q = 2
    fwd = [("dispatch", 0), ("dispatch", 1), ("compute", 0), ("combine", 0),
           ("compute", 1), ("combine", 1)]
    bwd = [("combine_bwd", 1), ("combine_bwd", 0), ("dispatch_bwd", 1),
           ("dispatch_bwd", 0)]
    for tag in ("f2", "d2"):
        logs = [_a2a_log(out, tag) for out in ranks]
        assert all(log == logs[0] for log in logs[1:])
        step = fwd * LAYERS + (fwd + bwd) * LAYERS
        assert logs[0] == step * SPEC["steps"]
        assert len(bwd) == 2 * q


# ------------------------------------------------------ (d) the cells
SERVE_JOB = dict(mesh=[2, 2], axes=["data", "model"])
SERVE_CASES = [dict(tag="q1", arch=A, factor=AMPLE, chunks=1),
               dict(tag="q2", arch=A, factor=AMPLE, chunks=2)]


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    from _torch_serve import T

    workdir = tmp_path_factory.mktemp("moecells")
    for case in SERVE_CASES:
        cfg = serve_case_cfg(jax_arch(A).reduced(), case)
        tree = numpy_params(jax_build(cfg, JaxOptions(dtype=jnp.float32,
                                                      scan_layers=False)))
        np.savez(workdir / f"{case['tag']}.npz",
                 **{f"leaf{i}": np.asarray(x, np.float32)
                    for i, x in enumerate(jax.tree.leaves(tree))})
    job = dict(SERVE_JOB, serve_cells=dict(SERVE_JOB, cases=SERVE_CASES))
    return T, spawn(job, None, workdir, SPAWN_DEADLINE_S)


def test_cells_chunk_the_moe_all_to_alls(serve_runs):
    """The prefill and decode cells of reduced Qwen3-30B-A3B on (2, 2)
    with ``moe_a2a_chunks`` 2: 2Q dispatches and combines a MoE layer in
    the prefill (the rank's token block) and in each decode step (the
    batch is the token domain), every other all-to-all as at Q = 1, and
    Q = 1's logits bit for bit on every rank."""
    steps, ranks = serve_runs
    for out in ranks:
        np.testing.assert_array_equal(out["q2_logits"], out["q1_logits"])
        for tag, q in (("q1", 1), ("q2", 2)):
            np.testing.assert_array_equal(
                out[f"{tag}_moe_a2a"], [2 * q * LAYERS,
                                        2 * q * LAYERS * steps])
        assert (out["q2_a2a"] - out["q1_a2a"]
                == 2 * LAYERS * (1 + steps))
        assert out["q2_prefill_a2a"] - out["q1_prefill_a2a"] == 2 * LAYERS


def test_build_cell_passes_the_chunks_into_its_options():
    """``build_cell``'s default options carry ``moe_a2a_chunks`` from its
    parallel config, as the reference's do; the Trainer's too."""
    cfg = get_arch(A).reduced()
    par = ParallelConfig(moe_a2a_chunks=2)
    for shape in (ShapeConfig("p", 16, 2, "prefill"),
                  ShapeConfig("d", 16, 2, "decode"),
                  ShapeConfig("t", 16, 2, "train")):
        assert build_cell(cfg, shape, parallel=par).model.opt \
            .moe_a2a_chunks == 2
    run, _ = tp_run(SPEC, _case("x", 2), "unused")
    assert Trainer(run, device="cpu").options.moe_a2a_chunks == 2


def test_moe_trains_where_it_raised(tmp_path):
    """What replaced the raises: ``check_ported`` passes the MoE family on
    a TP mesh and ``moe_a2a_chunks > 1`` with or without a mesh; without
    a "model" axis the chunks are read nowhere (the dense dispatch), so a
    Trainer at Q = 2 trains Q = 1's steps bit for bit."""
    run, opts = tp_run(SPEC, _case("x", 2), tmp_path)
    mesh = ProcessMesh(("data", "model"), (1, 2), 0, torch.device("cpu"))
    check_ported(run.parallel, mesh)
    check_ported(run.parallel, None)
    one = dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, moe_a2a_chunks=1))
    got = []
    for r, q in ((run, 2), (one, 1)):
        t = Trainer(r, options=dataclasses.replace(opts, moe_a2a_chunks=q),
                    device="cpu")
        t.init_state(seed=1)
        t.train(2)
        got.append((t.metrics_log, flat(t.params)))
    assert [m["loss"] for m in got[0][0]] == [m["loss"] for m in got[1][0]]
    np.testing.assert_array_equal(got[0][1], got[1][1])


# --------------------------------------------------- (e) blockwise
@pytest.mark.parametrize("impl", ["blockwise", "blockwise_unrolled"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("sq,chunk", [(32, 8), (30, 8), (16, 1024)])
def test_blockwise_matches_jax(impl, window, sq, chunk):
    """Blockwise attention (chunks of query rows, the dense function where
    the chunk does not divide the rows) against the JAX package's
    ``sdpa``, float32, GQA (4 query heads over 2 KV heads), causal, with
    and without a window: rtol 1e-5."""
    rng = np.random.default_rng(sq + chunk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq), (2, sq))
    want = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                    causal=True, window=window, impl=impl, chunk=chunk)
    got = attn.sdpa(*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in (q, k, v, pos, pos)),
                    causal=True, window=window, impl=impl, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    dense = attn.sdpa(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in (q, k, v, pos, pos)),
                      causal=True, window=window, impl="dense")
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------ (f) remat dots
@pytest.mark.parametrize("arch", [A, "qwen3-8b"])
def test_remat_dots_trains_as_full_and_as_jax(jax_runs, arch):
    """Without a mesh, 3 steps under remat "dots" and "full" give the same
    losses, grad norms and parameters bit for bit (the policy changes
    what is kept, not what is computed), and match the JAX Trainer under
    remat "dots" at rtol 1e-4."""
    case = dict(_case("x", 1, "dots"), arch=arch)
    if arch != A:
        case["capacity"] = None
    got = {}
    for remat in ("full", "dots"):
        c = dict(case, remat=remat)
        run, opts = tp_run(SPEC, c, "unused")
        t = Trainer(run, options=opts, device="cpu")
        t.init_state(params=_port_params(_numpy_tree(c), c))
        t.train(SPEC["steps"])
        got[remat] = ({k: [m[k] for m in t.metrics_log]
                       for k in ("loss", "grad_norm")}, flat(t.params))
    assert got["dots"][0] == got["full"][0]
    np.testing.assert_array_equal(got["dots"][1], got["full"][1])
    want, jparams, jv = jax_runs(case, remat="dots")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["dots"][0][key], want[key], rtol=1e-4)
    _close(got["dots"][1], case, want, jparams, jv)


def test_remat_dots_keeps_exactly_the_projections():
    """The policy's choices over one forward of reduced Qwen3-30B-A3B and
    reduced Qwen3-8B: it keeps the attention's q, k, v and output
    projections (einsum's batch-1 ``bmm``) and every ``mm`` (the router,
    the MLP's three), and recomputes every other ``bmm`` (the attention's
    scores and values, the experts' products)."""
    saved = collections.Counter()

    def policy(ctx, op, *args, **kw):
        choice = tfm._dots_policy(ctx, op, *args, **kw)
        if not ctx.is_recompute and "mm" in str(op):
            saved[(str(op), choice.name)] += 1
        return choice

    ctx_fn = functools.partial(create_selective_checkpoint_contexts, policy)
    orig = tfm._DOTS_CONTEXT
    tfm._DOTS_CONTEXT = ctx_fn
    try:
        for arch, mm, recompute in ((A, 1, 2 + 3), ("qwen3-8b", 3, 2)):
            saved.clear()
            cfg = get_arch(arch).reduced()
            model = build_model(cfg, ModelOptions(dtype=torch.float32,
                                                  remat="dots",
                                                  scan_layers=False))
            params = model.init(0, "cpu")
            params.requires_grad_(True)
            toks = torch.zeros(2, 8, dtype=torch.long)
            model.train_loss(params, {"tokens": toks,
                                      "targets": toks}).backward()
            n = cfg.num_layers
            assert saved == {("aten.bmm.default", "MUST_SAVE"): 4 * n,
                             ("aten.mm.default", "MUST_SAVE"): mm * n,
                             ("aten.bmm.default", "PREFER_RECOMPUTE"):
                                 recompute * n}, (arch, saved)
    finally:
        tfm._DOTS_CONTEXT = orig


def test_launcher_trains_moe_tensor_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch
    qwen3-moe-30b-a3b --mesh production --model-axis 2`` trains the
    reduced model on a (1, 2) ("data", "model") gloo mesh, its experts
    over the two ranks: both ranks print the same finite losses, and the
    checkpoint restores into a one-rank Trainer at the step it was
    written."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import train as launch_train

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(repo / "src")] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", A, "--mesh", "production", "--model-axis", "2",
         "--device", "cpu", "--steps", "2", "--checkpoint-dir",
         str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_DEADLINE_S, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = re.findall(r"\[train\] loss (\S+) -> (\d+\.\d+)", out.stdout)
    assert len(losses) == 2 and len(set(losses)) == 1, out.stdout
    assert all(np.isfinite(float(x)) for x in losses[0])
    run = launch_train.build_run(A, steps=2, checkpoint_dir=str(tmp_path))
    one = Trainer(run, device="cpu")
    assert one.restore_if_available() and one.step == 2
