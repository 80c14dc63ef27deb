"""The port's ZeRO-3 (FSDP) on the CPU, against the JAX package where it has
a counterpart: the flat-buffer layout field for field (keys, leaf order,
offsets, sizes, padding) for four architectures, scanned and unrolled,
under every bucket order; round trips with padding; the re-layout and the
checkpoint import across layouts and across the two packages, bit for bit;
the sharded init against a full init; the streaming gather against the
unshard; the one-rank ZeRO-3 Trainer against the JAX Trainer with
param_shard (float32, rtol 1e-4); streaming bit-equal to gathering all;
the collectives' issue order; AdamW's padding; and the fault-tolerant
runner. Multi-rank runs (gloo) are in ``tests/test_torch_dist.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import ZERO3_CASES, check_zero3_log, zero3_trainer
from _torch_jax import f32, numpy_params

from repro.checkpoint import restore_fsdp_checkpoint as jrestore_fsdp
from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.core import overlap as jov
from repro.launch.mesh import make_mesh as jmesh
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import (restore_checkpoint,
                                    restore_fsdp_checkpoint, save_checkpoint)
from repro_torch.config import ParallelConfig, RunConfig, TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.core import overlap as tov
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import ProcessMesh, make_mesh
from repro_torch.launch.steps import (check_ported, fsdp_init_state,
                                      fsdp_layout_for)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.runtime.ft import FaultTolerantRunner
from repro_torch.runtime.trainer import Trainer

ARCHS = ["qwen3-8b", "granite-3-2b", "internlm2-1.8b", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its models are tiny, and
    beside other test processes on the same cores a thread pool per
    process makes every small op wait on the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
STREAM = ParallelConfig(**ZERO3_CASES["stream"])
GATHER = ParallelConfig(**ZERO3_CASES["gather"])


def _one_rank():
    return make_mesh((1,), ("data",), "cpu")


def _groups(layout):
    return [dataclasses.astuple(g) for g in layout.groups]


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("order", ["reverse_topo", "tree", "layer"])
@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_layout_equals_jax(arch, scan, order):
    """fsdp_layout of the reduced model's parameters over 4 shards, 8
    buckets: the same groups as the JAX package's, field for field (key,
    bucket, dtype name, leaf indices, shapes, offsets, size, padded), the
    same leaf paths in the same order, and the same shard bytes."""
    jm = jax_build(jax_arch(arch).reduced(), JaxOptions(scan_layers=scan))
    tm = build_model(get_arch(arch).reduced(), ModelOptions(scan_layers=scan))
    use = order != "tree"
    want = jov.fsdp_layout(jm.abstract_params(), 4, 8,
                           jm.param_layers() if use else None, order)
    got = tov.fsdp_layout(tm.param_specs(), 4, 8,
                          tm.param_layers() if use else None, order)
    assert _groups(got) == _groups(want)
    assert (got.n_shards, got.num_leaves) == (want.n_shards, want.num_leaves)
    jpaths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(
                  jm.abstract_params())[0]]
    assert list(tov.leaf_paths(got.treedef)) == jpaths
    assert got.shard_bytes() == want.shard_bytes()


def test_layout_for_the_trainer_equals_jax():
    """fsdp_layout_for on a one-rank ("data",) mesh, gathering all
    (reverse_topo, 8 buckets) and streaming (one bucket per layer): the
    JAX package's layouts; streaming keys equal gathering-all keys under
    bucket_order="layer"."""
    jm = jax_build(jax_arch("qwen3-8b").reduced(),
                   JaxOptions(scan_layers=False))
    tm = build_model(get_arch("qwen3-8b").reduced(),
                     ModelOptions(scan_layers=False))
    from repro.launch.steps import fsdp_layout_for as jlayout_for

    for par in (ParallelConfig(param_shard=True, scan_layers=False),
                STREAM, GATHER):
        jpar = JaxParallel(**{f.name: getattr(par, f.name)
                              for f in dataclasses.fields(par)})
        got, axes = fsdp_layout_for(tm, par, _one_rank())
        want, jaxes = jlayout_for(jm, jpar, jmesh((1,), ("data",)))
        assert _groups(got) == _groups(want) and axes == jaxes == ("data",)
    assert (fsdp_layout_for(tm, STREAM, _one_rank())[0].keys
            == fsdp_layout_for(tm, GATHER, _one_rank())[0].keys)


def _mixed_params():
    """A mixed-dtype tree (float32 and bf16) over three depths, and its
    provenance, as numpy (for JAX) and as tensors."""
    rng = np.random.default_rng(0)
    tree = {"emb": rng.standard_normal((7, 6)).astype(np.float32),
            "w1": rng.standard_normal((5, 5)).astype(np.float32),
            "n1": np.ones(3, np.float32),
            "head": rng.standard_normal(11).astype(np.float32)}
    layers = {"emb": 0, "w1": 1, "n1": 1, "head": 2}
    jtree = {k: jnp.asarray(v, jnp.bfloat16 if k == "w1" else jnp.float32)
             for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "w1"
                                       else torch.float32)
             for k, v in tree.items()}
    return jtree, ttree, layers


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_roundtrip_with_padding(n_shards):
    """Forward-order buckets, per-dtype buffers padded to a multiple of
    n_shards (less than n_shards of padding), the JAX package's layout and
    flat buffers; unshard(shard(tree)) is the tree bit for bit."""
    jtree, ttree, layers = _mixed_params()
    layout = tov.fsdp_layout(ttree, n_shards, 3, layers=layers)
    jlayout = jov.fsdp_layout(jtree, n_shards, 3, layers=layers)
    assert _groups(layout) == _groups(jlayout)
    for g in layout.groups:
        assert g.padded % n_shards == 0 and g.padded - g.size < n_shards
    flat = tov.fsdp_shard_full(ttree, layout)
    jflat = jov.fsdp_shard_full(jtree, jlayout)
    assert set(flat) == set(layout.keys)
    for k in flat:
        np.testing.assert_array_equal(f32(flat[k]), f32(jflat[k]))
    back = tov.fsdp_unshard_full(flat, layout)
    for a, b in zip(tree_leaves(ttree), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tov.fsdp_shard_full({"emb": ttree["emb"]}, layout)


def test_relayout_bit_exact_and_mismatch_raises(tmp_path):
    """fsdp_relayout of params and float32 moments from the 2-bucket
    reverse_topo layout to the per-layer one: the new layout's buffers of
    the same tree, bit for bit, equal to the JAX package's re-layout; a
    layout of another tree raises ValueError, and so does restoring a
    checkpoint structurally into another layout (naming its buffers)."""
    jm = jax_build(jax_arch("qwen3-8b").reduced(),
                   JaxOptions(scan_layers=False))
    tree = numpy_params(jm)
    model = build_model(get_arch("qwen3-8b").reduced(),
                        ModelOptions(scan_layers=False))
    params = params_from_jax(tree, model.cfg, model.opt, "cpu")
    old = tov.fsdp_layout(params, 3, 2, model.param_layers())
    new = tov.fsdp_layout(params, 3, 8, model.param_layers(), "layer")
    jold = jov.fsdp_layout(jm.abstract_params(), 3, 2, jm.param_layers())
    jnew = jov.fsdp_layout(jm.abstract_params(), 3, 8, jm.param_layers(),
                           "layer")
    flat = tov.fsdp_shard_full(params, old)
    got = tov.fsdp_relayout(flat, old, new)
    want = tov.fsdp_shard_full(params, new)
    jwant = jov.fsdp_relayout(jov.fsdp_shard_full(
        jax.tree.map(jnp.asarray, tree), jold), jold, jnew)
    for k in want:
        assert torch.equal(got[k], want[k])
        np.testing.assert_array_equal(f32(got[k]), f32(jwant[k]))
    moments = {k: torch.randn(v.shape) for k, v in flat.items()}
    for g in old.groups:
        moments[g.key][g.size:] = 0
    back = tov.fsdp_relayout(tov.fsdp_relayout(moments, old, new), new, old)
    for k, v in back.items():
        assert v.dtype == torch.float32 and torch.equal(v, moments[k])
    other = tov.fsdp_layout({"w": torch.zeros(3)}, 3)
    with pytest.raises(ValueError, match="leaves"):
        tov.fsdp_relayout(flat, old, other)
    save_checkpoint(str(tmp_path), 1, {"params": flat})
    target = {"params": {g.key: torch.empty(0) for g in new.groups}}
    with pytest.raises(ValueError, match="restore_fsdp_checkpoint") as err:
        restore_checkpoint(str(tmp_path), target)
    assert all(g.key in str(err.value) for g in new.groups)


# ---------------------------------------------------------- init, stream
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b"])
def test_sharded_init_equals_full_init(arch):
    """fsdp_init_state draws each bucket and keeps its shard: the same bits
    as model.init of the whole tree, sharded; zero float32 moments, step
    0, trainable shards."""
    model = build_model(get_arch(arch).reduced(),
                        ModelOptions(scan_layers=False))
    pflat, opt, layout = fsdp_init_state(model, STREAM, _one_rank(), 7)
    full = tov.fsdp_shard_full(model.init(7, "cpu"), layout)
    assert list(pflat) == list(full) == list(layout.keys)
    for k in pflat:
        assert torch.equal(pflat[k].detach(), full[k])
        assert pflat[k].requires_grad
    for mom in ("m", "v"):
        for v in opt[mom].values():
            assert v.dtype == torch.float32 and not v.any()
    assert int(opt["step"]) == 0


def test_materialize_equals_unshard_and_scatters_its_gradient():
    """FsdpStream.materialize of the first layer's depth on one rank: that
    layer's leaves of the unshard, None elsewhere (the JAX package's
    stream gives the same holes); its backward reduce-scatters the
    leaves' gradients into the layer's buffers (on one rank: the packed
    gradients), landed by finish(), zeros for the other buffers."""
    model = build_model(get_arch("qwen3-8b").reduced(),
                        ModelOptions(scan_layers=False))
    pflat, _, layout = fsdp_init_state(model, STREAM, _one_rank(), 0)
    log = []
    stream = tov.fsdp_stream(layout, model.param_layers(), _one_rank(),
                             ("data",), log=log)
    assert stream.depths == tuple(range(2 + model.cfg.num_layers))
    full = tree_leaves(tov.fsdp_unshard_full(
        {k: v.detach() for k, v in pflat.items()}, layout))
    tags = tree_leaves(model.param_layers())
    stream.start(pflat)
    got = tree_leaves(stream.materialize(pflat, 1))
    assert [g is None for g in got] == [t != 1 for t in tags]
    loss = sum((w.float() * (i + 1)).sum() for i, w in enumerate(got)
               if w is not None)
    for g, w in zip(full, got):
        assert w is None or torch.equal(g, w)
    stream.backward_phase()
    loss.backward()
    grads = stream.finish()
    want = tov.fsdp_shard_full(_grad_tree(full, got), layout)
    for g in layout.groups:
        exp = want[g.key] if g.bucket == 1 else torch.zeros_like(grads[g.key])
        assert torch.equal(grads[g.key], exp), g.key
    assert [e[0] for e in log if e[0] != "free"] == (
        ["ag"] * len(stream.groups_at(1)) * 2
        + ["rs"] * len(stream.groups_at(1)))
    jm = jax_build(jax_arch("qwen3-8b").reduced(),
                   JaxOptions(scan_layers=False))
    jstream = jov.fsdp_stream(jov.fsdp_layout(
        jm.abstract_params(), 1, 8, jm.param_layers(), "layer"),
        jm.param_layers(), ("data",))
    assert stream.depths == jstream.depths


def _grad_tree(full, got):
    """The gradient of sum((i + 1) * leaf_i) over the materialized leaves:
    i + 1 where leaf i was materialized, zeros elsewhere."""
    out = []
    for i, (g, w) in enumerate(zip(full, got)):
        out.append(torch.zeros_like(g) if w is None
                   else torch.full_like(g, float(i + 1)))
    return out


# ----------------------------------------------------------- the trainer
def _jax_zero3(tmp_path, tree, streaming, steps):
    """The JAX Trainer with param_shard on a one-device ("data",) mesh,
    reduced qwen3-8b in float32, from `tree`."""
    cfg = jax_arch("qwen3-8b").reduced()
    par = JaxParallel(**(ZERO3_CASES["stream"] if streaming else dict(
        param_shard=True, scan_layers=False, remat="none")))
    train = JaxTrain(global_batch=4, seq_len=32, lr=5e-3, warmup_steps=2,
                     total_steps=steps, checkpoint_every=10 ** 6, seed=3,
                     checkpoint_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(JaxRun(cfg, par, train), mesh=jmesh((1,), ("data",)),
                    options=JaxOptions(dtype=jnp.float32, scan_layers=False,
                                       remat=par.remat,
                                       fused_xent=not streaming))
    jt.init_state()
    jt.params = jov.fsdp_shard_full(jax.tree.map(jnp.asarray, tree),
                                    jt._fsdp_layout)
    jt.train(steps)
    return jt


def _port_zero3(tmp_path, tree, streaming, steps):
    par = (STREAM if streaming else
           ParallelConfig(param_shard=True, scan_layers=False, remat="none"))
    run = RunConfig(get_arch("qwen3-8b").reduced(), par, TrainConfig(
        global_batch=4, seq_len=32, lr=5e-3, warmup_steps=2,
        total_steps=steps, checkpoint_every=10 ** 6, seed=3,
        checkpoint_dir=str(tmp_path / "port")))
    opts = ModelOptions(dtype=torch.float32, scan_layers=False,
                        remat=par.remat, fused_xent=not streaming)
    t = Trainer(run, mesh=_one_rank(), options=opts, device="cpu")
    t.init_state(params=params_from_jax(tree, run.model, opts, "cpu"))
    t.train(steps)
    return t


@pytest.fixture(scope="module")
def zero3_pair(tmp_path_factory):
    """(JAX trainer, port trainer) of _jax_zero3 and _port_zero3, 2 steps
    from one numpy draw, gathering all or streaming (shared by the
    trainer and the checkpoint tests)."""
    cache = {}

    def get(streaming):
        if streaming not in cache:
            tmp = tmp_path_factory.mktemp(f"zero3_{int(streaming)}")
            tree = numpy_params(jax_build(
                jax_arch("qwen3-8b").reduced(),
                JaxOptions(dtype=jnp.float32, scan_layers=False)))
            cache[streaming] = (_jax_zero3(tmp, tree, streaming, 2),
                                _port_zero3(tmp, tree, streaming, 2))
        return cache[streaming]
    return get


@pytest.mark.parametrize("streaming", [False, True])
def test_zero3_trainer_matches_jax(zero3_pair, streaming):
    """The port's ZeRO-3 Trainer on a one-rank ("data",) mesh against the
    JAX Trainer with param_shard on a one-device mesh, gathering all
    (8 reverse_topo buckets, the fused loss) and streaming (per-layer
    buckets, the unfused loss, remat): reduced qwen3-8b, float32, 2 steps
    from the same parameters. Losses, grad norms and the final flat
    buffers within rtol 1e-4 (of each buffer's largest entry), the same
    layout keys."""
    jt, t = zero3_pair(streaming)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in t.metrics_log],
                                   [m[key] for m in jt.metrics_log],
                                   rtol=1e-4)
    assert list(t.params) == sorted(jt.params)
    for k, v in t.params.items():
        want = f32(jt.params[k])
        np.testing.assert_allclose(f32(v), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("arch,accum", [("qwen3-8b", 1), ("qwen3-8b", 2),
                                        ("granite-3-2b", 1)])
def test_streaming_bit_equal_to_gather_all(arch, accum):
    """On one rank, bf16, 3 steps: streaming (per-layer gathers inside the
    remat regions) and gathering all on the same per-layer layout give
    the same losses, grad norms, flat params and both moments, bit for
    bit; with 2 microbatches too, and for a tied embedding (granite,
    whose depth-0 buffer is gathered twice and reduce-scattered twice).
    The first loss equals the replicated trainer's with the same options
    bit for bit, its grad norm within rtol 1e-5 (the norm is summed by
    flat buffer instead of by leaf)."""
    spec = dict(arch=arch, steps=3, global_batch=4, seq_len=16, lr=5e-3,
                dtype="bf16", accum=accum)
    runs = {}
    for case in ("stream", "gather", "repl"):
        t = zero3_trainer(spec, case, None if case == "repl" else
                          _one_rank(), "cpu")
        t.init_state(seed=0)
        t.train(spec["steps"] if case != "repl" else 1)
        runs[case] = t
    s, g, r = runs["stream"], runs["gather"], runs["repl"]
    for key in ("loss", "grad_norm"):
        assert [m[key] for m in s.metrics_log] == [m[key] for m in
                                                   g.metrics_log]
    for k in s.params:
        assert torch.equal(s.params[k], g.params[k])
        for mom in ("m", "v"):
            assert torch.equal(s.opt_state[mom][k], g.opt_state[mom][k])
    assert s.metrics_log[0]["loss"] == r.metrics_log[0]["loss"]
    np.testing.assert_allclose(s.metrics_log[0]["grad_norm"],
                               r.metrics_log[0]["grad_norm"], rtol=1e-5)


def test_issue_order_on_one_rank():
    """The logged collectives of 2 steps on one rank, reduced qwen3-8b:
    gathering all, one all-gather per buffer in forward layout order, then
    one reduce-scatter per buffer in reverse; streaming, gathers in forward
    depth order, regathers and reduce-scatters in reverse depth order, at
    most fsdp_working_set buckets gathered at once (check_zero3_log): 2
    with the prefetch of the next layer, 1 without it (a working set of
    1)."""
    spec = dict(arch="qwen3-8b", steps=2, global_batch=2, seq_len=16,
                lr=5e-3, dtype="bf16")
    for case, ws in (("gather", 2), ("stream", 2), ("stream", 1)):
        t = zero3_trainer(spec, case, _one_rank(), "cpu")
        t.run = dataclasses.replace(t.run, parallel=dataclasses.replace(
            t.run.parallel, fsdp_working_set=ws))
        t.init_state(seed=0)
        t.fsdp_log = []
        t.train(2)
        log = [f"{w}:{k}" for w, k in t.fsdp_log]
        check_zero3_log(log, t._fsdp_layout.keys, case == "stream", 2, ws)
        assert len(t._fsdp_layout.keys) == 2 * (2 + t.run.model.num_layers
                                                ) - 1   # embed: bf16 only


def test_zero3_needs_a_dp_only_mesh(tmp_path):
    """param_shard without a mesh, or on a mesh with a TP axis of 2 ranks,
    raises ValueError (it never quietly replicates); fsdp_layout_for
    too."""
    run = RunConfig(get_arch("qwen3-8b").reduced(), STREAM,
                    TrainConfig(checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="param_shard"):
        Trainer(run, device="cpu")
    tp = ProcessMesh(("data", "model"), (1, 2), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="param_shard"):
        check_ported(run.parallel, tp)
    with pytest.raises(ValueError, match="param_shard"):
        fsdp_layout_for(build_model(run.model), STREAM, None)
    check_ported(run.parallel, _one_rank())


def test_adamw_keeps_the_padding_zero():
    """AdamW with weight decay on flat buffers cut for 3 shards (padding
    in every buffer) whose gradients are zero in the padding: the padding
    of params and moments stays zero over 5 steps."""
    tree = {"a": torch.randn(7, 5), "b": torch.randn(4)}
    layout = tov.fsdp_layout(tree, 3)
    params = tov.fsdp_shard_full(tree, layout)
    state = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()},
             "step": torch.zeros((), dtype=torch.int32)}
    cfg = AdamWConfig(weight_decay=0.1)
    for _ in range(5):
        grads = tov.fsdp_shard_full({k: torch.randn(v.shape)
                                     for k, v in tree.items()}, layout)
        adamw_update(grads, state, params, cfg, torch.tensor(1e-2))
    assert all(g.padded > g.size for g in layout.groups)
    for flat in (params, state["m"], state["v"]):
        for g in layout.groups:
            assert not flat[g.key][g.size:].any()


# ------------------------------------------------------------ checkpoints
def test_zero3_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Streaming, bf16: 4 steps straight against 2, a checkpoint (the
    global flat buffers), a new Trainer restored from it and 2 more: the
    same losses and flat state bit for bit."""
    spec = dict(arch="qwen3-8b", steps=4, global_batch=2, seq_len=16,
                lr=5e-3, dtype="bf16")
    straight = zero3_trainer(spec, "stream", _one_rank(), "cpu")
    straight.init_state(seed=0)
    straight.train(4)
    spec["ckpt"] = str(tmp_path / "b")
    first = zero3_trainer(spec, "stream", _one_rank(), "cpu")
    first.init_state(seed=0)
    first.train(2)
    first.save()
    first.ckpt.wait()
    second = zero3_trainer(spec, "stream", _one_rank(), "cpu")
    assert second.restore_if_available() and second.step == 2
    second.train(2)
    assert [m["loss"] for m in second.metrics_log] == [
        m["loss"] for m in straight.metrics_log[2:]]
    for a, b in zip(tree_leaves({"p": straight.params,
                                 "o": straight.opt_state}),
                    tree_leaves({"p": second.params, "o": second.opt_state})):
        assert torch.equal(a, b)


def test_zero3_checkpoints_cross_packages_and_layouts(zero3_pair):
    """A checkpoint of the port's ZeRO-3 Trainer (8 reverse_topo buckets)
    restores through the JAX package's restore_fsdp_checkpoint into the
    per-layer layout, and one of the JAX Trainer (per-layer layout)
    through the port's into the 8-bucket one; both bit-exact against
    re-cutting the writer's state (params and float32 moments)."""
    jm = jax_build(jax_arch("qwen3-8b").reduced(),
                   JaxOptions(dtype=jnp.float32, scan_layers=False))
    t = zero3_pair(False)[1]
    t.save()
    t.ckpt.wait()
    jnew = jov.fsdp_layout(jm.abstract_params(), 1, 8, jm.param_layers(),
                           "layer")
    jold = jov.fsdp_layout(jm.abstract_params(), 1, 8, jm.param_layers())
    step, state, extra = jrestore_fsdp(t.run.train.checkpoint_dir, jold,
                                       jnew)
    assert step == 2 and extra["data_step"] == 2
    mine = {"params": t.params, "m": t.opt_state["m"],
            "v": t.opt_state["v"]}
    new = fsdp_layout_for(t.model, STREAM, _one_rank())[0]
    for name, got in (("params", state["params"]),
                      ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        want = tov.fsdp_relayout({k: v.detach() for k, v in
                                  mine[name].items()},
                                 t._fsdp_layout, new)
        for k in want:
            np.testing.assert_array_equal(f32(got[k]), f32(want[k]))
    assert int(state["opt"]["step"]) == 2

    jt = zero3_pair(True)[0]
    jt.save()
    jt.ckpt.wait()
    step, state, _ = restore_fsdp_checkpoint(jt.run.train.checkpoint_dir,
                                             new, t._fsdp_layout)
    assert step == 2 and int(state["opt"]["step"]) == 2
    jflat = {"params": jt.params, "m": jt.opt_state["m"],
             "v": jt.opt_state["v"]}
    for name, got in (("params", state["params"]),
                      ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        want = jov.fsdp_relayout(jflat[name], jnew, jold)
        for k in want:
            assert got[k].dtype == (torch.float32 if name != "params"
                                    else tov.torch_dtype(
                                        jold.groups[0].dtype))
            np.testing.assert_array_equal(f32(got[k]), f32(want[k]))


# ------------------------------------------------------ fault tolerance
def _ft_run(tmp_path, steps=6, every=2):
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(),
                              num_layers=2)
    return RunConfig(model=cfg,
                     parallel=ParallelConfig(remat="none"),
                     train=TrainConfig(global_batch=4, seq_len=32, lr=5e-3,
                                       warmup_steps=2, total_steps=steps,
                                       checkpoint_every=every,
                                       checkpoint_dir=str(tmp_path / "c"),
                                       keep_checkpoints=2, seed=3))


def test_fault_tolerant_runner_recovers(tmp_path):
    """A failure injected at step 3: the runner restarts from the step-2
    checkpoint and completes all 6 steps, on the same trajectory as an
    uninterrupted run; a persistent failure exhausts the budget (2
    restarts: 3 failures) and raises."""
    run = _ft_run(tmp_path)
    fired = []

    def failure_hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    runner = FaultTolerantRunner(lambda: Trainer(run, device="cpu"),
                                 max_restarts=2)
    trainer = runner.run(6, failure_hook=failure_hook)
    assert trainer.step == 6 and runner.restarts == 1 and fired == [3]
    straight = Trainer(_ft_run(tmp_path / "s"), device="cpu")
    straight.train(6)
    assert trainer.metrics_log[-1]["loss"] == straight.metrics_log[-1]["loss"]

    def always_fail(step):
        raise RuntimeError("persistent failure")

    runner = FaultTolerantRunner(lambda: Trainer(_ft_run(tmp_path / "f"),
                                                 device="cpu"),
                                 max_restarts=2)
    with pytest.raises(RuntimeError, match="persistent"):
        runner.run(4, failure_hook=always_fail)
    assert runner.restarts == 3
    with pytest.raises(ValueError):
        FaultTolerantRunner(lambda: None, max_restarts=-1)


def test_train_launcher_restarts(tmp_path, capsys, monkeypatch):
    """launch/train.py --restarts 1 with a failure injected into the
    fourth step: the runner restarts from the latest checkpoint and
    reaches step 4 with one restart."""
    orig, fired = Trainer.train, []

    def flaky(self, num_steps, failure_hook=None):
        def hook(step):
            if step == 3 and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")
        return orig(self, num_steps, failure_hook=hook)

    monkeypatch.setattr(Trainer, "train", flaky)
    assert launch_train.main(["--arch", "internlm2-1.8b", "--device", "cpu",
                              "--steps", "4", "--restarts", "1",
                              "--checkpoint-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] reached step 4 (1 restarts used)"
    assert fired == [3]
