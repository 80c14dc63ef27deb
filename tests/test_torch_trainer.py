"""The port's Trainer, checkpointer and training launcher on the CPU: three
steps from the JAX package's parameters against the JAX ``Trainer``
(losses, grad norms and final parameters at rtol 1e-4, float32, reduced
internlm2-1.8b, qwen3-moe-30b-a3b, mamba2-780m and recurrentgemma-2b),
checkpoints that restore across the two packages, a resumed run equal to an
uninterrupted one bit for bit, the launcher's output lines, and the
``NotImplementedError``s of what the port does not train.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import f32, numpy_params

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint.checkpointer import save_checkpoint as jsave
from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.config import ParallelConfig, RunConfig, TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.steps import check_ported
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.optim import adamw_init
from repro_torch.runtime.trainer import Trainer

STEPS = 3


def _runs(tmp, accum=1, arch="internlm2-1.8b", **parallel):
    train = dict(global_batch=4, seq_len=32, lr=5e-3, warmup_steps=2,
                 total_steps=STEPS, checkpoint_every=100,
                 checkpoint_dir=str(tmp / "ckpt"), seed=3)
    par = dict(remat="none", accum_steps=accum, **parallel)
    return (RunConfig(model=get_arch(arch).reduced(),
                      parallel=ParallelConfig(**par),
                      train=TrainConfig(**train)),
            JaxRun(model=jax_arch(arch).reduced(),
                   parallel=JaxParallel(**par), train=JaxTrain(**train)))


def _jax_tree(dtype=jnp.float32, arch="internlm2-1.8b"):
    """The reduced model's parameters, unrolled (a scanned draw takes
    fan_in = the layer count, ROADMAP.md Queue 3, and its large weights
    amplify every rounding over three steps)."""
    jm = jax_build(jax_arch(arch).reduced(),
                   JaxOptions(dtype=dtype, scan_layers=False))
    return numpy_params(jm)


def _train_both(tmp_path, arch, scan, accum):
    """Three steps of the JAX Trainer (no mesh, unrolled, float32) and of
    the port's (scanned or not) from the same parameters. Returns (port
    trainer, JAX trainer, JAX's final parameters in the port's layout)."""
    run, jrun = _runs(tmp_path, accum, arch)
    tree = _jax_tree(arch=arch)
    jt = JaxTrainer(jrun, options=JaxOptions(dtype=jnp.float32,
                                             scan_layers=False))
    jt.init_state()
    jt.params = jax.tree.map(jnp.asarray, tree)
    jt.opt_state = jadamw_init(jt.params)
    jt.train(STEPS)
    opts = ModelOptions(dtype=torch.float32, scan_layers=scan)
    t = Trainer(run, options=opts, device="cpu")
    t.init_state(params=params_from_jax(tree, run.model, opts, "cpu"))
    t.train(STEPS)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in t.metrics_log],
                                   [m[key] for m in jt.metrics_log],
                                   rtol=1e-4)
    return t, jt, params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  run.model, opts, "cpu")


@pytest.mark.parametrize("scan,accum", [(True, 1), (False, 2)])
def test_trainer_matches_jax(tmp_path, scan, accum):
    """Three steps from the same parameters: the port (scanned, or
    unrolled over 2 microbatches) against the JAX Trainer without a mesh,
    float32: losses, grad norms, learning rates and final parameters."""
    t, _, want = _train_both(tmp_path, "internlm2-1.8b", scan, accum)
    for got, w in zip(tree_leaves(t.params), tree_leaves(want)):
        np.testing.assert_allclose(f32(got), f32(w), rtol=1e-4,
                                   atol=1e-4 * np.abs(f32(w)).max())


@pytest.mark.parametrize("arch,scan,accum", [
    ("mamba2-780m", False, 1), ("mamba2-780m", True, 2),
    ("recurrentgemma-2b", False, 1)])
def test_recurrent_trainer_matches_jax(tmp_path, arch, scan, accum):
    """The recurrent families (reduced Mamba-2 and RecurrentGemma, no
    mesh, float32) train three steps from the same parameters as the JAX
    Trainer, whose scans run their ``ref`` path under jax.grad (its Pallas
    scans cannot be differentiated, ROADMAP.md Queue 3): losses, grad
    norms and learning rates at rtol 1e-4, the final parameters within
    1e-4 of each leaf's largest entry. Mamba-2 also scanned over 2
    microbatches (RecurrentGemma's stack is not uniform, so it is always
    unrolled)."""
    t, _, want = _train_both(tmp_path, arch, scan, accum)
    for got, w in zip(tree_leaves(t.params), tree_leaves(want)):
        np.testing.assert_allclose(f32(got), f32(w), rtol=1e-4,
                                   atol=1e-4 * np.abs(f32(w)).max())


def test_moe_trainer_matches_jax(tmp_path):
    """Reduced Qwen3-MoE (4 experts, top-2, capacity factor 1.25) trains
    on the dense capacity dispatch (no mesh, so no "model" axis), its loss
    including the aux load-balancing loss: three steps against the JAX
    Trainer, float32. Losses, grad norms and learning rates at rtol 1e-4;
    the final parameters at rtol 1e-4 of each leaf's largest entry, except
    where AdamW's step was set by a gradient at the rounding scale: where
    JAX's second moment is below (1e3 * eps)^2, AdamW divides a gradient of
    about eps by one of about eps, so the two frameworks' last-bit
    differences become O(1) differences in the step, and an entry may then
    differ by up to the sum of the three learning rates (the most AdamW
    can move it). Here that is embed[138, 21], whose first moment is 9e-10
    against the leaf's median of 2e-4. (Entries whose gradient is exactly 0 are
    held to rtol 1e-4.)"""
    t, jt, want = _train_both(tmp_path, "qwen3-moe-30b-a3b", False, 1)
    v = params_from_jax(jax.tree.map(np.asarray, jt.opt_state["v"]),
                        t.run.model, t.options, "cpu")
    eps, lr_sum = t.opt_cfg.eps, sum(m["lr"] for m in t.metrics_log)
    for got, w, vv in zip(tree_leaves(t.params), tree_leaves(want),
                          tree_leaves(v)):
        got, w = f32(got), f32(w)
        diff = np.abs(got - w)
        tiny = (f32(vv) > 0) & (f32(vv) < (1e3 * eps) ** 2)
        assert (diff[~tiny] <= 1e-4 * np.abs(w[~tiny])
                + 1e-4 * np.abs(w).max()).all()
        assert (diff[tiny] <= lr_sum).all()


def test_resume_equals_uninterrupted(tmp_path):
    """bf16, 4 steps straight against 2 steps, a checkpoint, a new Trainer
    restored from it and 2 more: the same losses and parameters bit for
    bit, and the data position restored."""
    run, _ = _runs(tmp_path / "a")
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, total_steps=4, checkpoint_every=2))
    straight = Trainer(run, device="cpu")
    straight.train(4)
    run_b = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_dir=str(tmp_path / "b")))
    first = Trainer(run_b, device="cpu")
    first.train(2)
    assert latest_step(run_b.train.checkpoint_dir) == 2
    second = Trainer(run_b, device="cpu")
    assert second.restore_if_available() and second.step == 2
    second.train(2)
    assert [m["loss"] for m in second.metrics_log] == [
        m["loss"] for m in straight.metrics_log[2:]]
    for a, b in zip(tree_leaves({"p": straight.params,
                                 "o": straight.opt_state}),
                    tree_leaves({"p": second.params, "o": second.opt_state})):
        assert torch.equal(a, b)


def _state(params):
    return {"params": params, "opt": adamw_init(params)}


def test_checkpoints_restore_across_packages(tmp_path):
    """A port checkpoint restores in the JAX package's restore_checkpoint
    and a JAX one in the port's (bf16 widened to float32 in the npz and
    cast back), scanned layout, with the same keys and values."""
    cfg = get_arch("internlm2-1.8b").reduced()
    tree = _jax_tree(jnp.bfloat16)
    port = params_from_jax(tree, cfg, ModelOptions(), "cpu")       # scanned
    state = _state(port)
    with torch.no_grad():
        for i, m in enumerate(tree_leaves(state["opt"]["m"])):
            m.fill_(0.5 + i)
    state["opt"]["step"].fill_(7)
    save_checkpoint(str(tmp_path / "p"), 5, state, extra={"data_step": 5})
    jm = jax_build(jax_arch("internlm2-1.8b").reduced(), JaxOptions())
    jparams = jax.tree.map(jnp.zeros_like, jm.abstract_params())
    jtarget = {"params": jparams, "opt": jadamw_init(jparams)}
    step, jtree, extra = jrestore(str(tmp_path / "p"), jtarget)
    assert (step, extra) == (5, {"data_step": 5})
    assert jax.tree.structure(jtree) == jax.tree.structure(jtarget)
    for got, want in zip(jax.tree.leaves(jtree), tree_leaves(state)):
        assert got.dtype == jnp.dtype(str(want.dtype).split(".")[1])
        np.testing.assert_array_equal(f32(got), f32(want))

    jsave(str(tmp_path / "j"), 9, jtree, extra={"data_step": 9})
    fresh = _state(build_model(cfg).init(1, "cpu"))
    step, back, extra = restore_checkpoint(str(tmp_path / "j"), fresh)
    assert (step, extra) == (9, {"data_step": 9})
    for got, want, like in zip(tree_leaves(back), tree_leaves(state),
                               tree_leaves(fresh)):
        assert got.dtype == like.dtype
        assert torch.equal(got, want)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The written arrays are the values at save(), not later in-place
    updates of the same tensors; a write error surfaces on wait()."""
    p = {"w": torch.arange(6.0)}
    ck = AsyncCheckpointer(str(tmp_path / "c"), keep=2)
    ck.save(1, p)
    p["w"].add_(100.0)
    ck.wait()
    _, back, _ = restore_checkpoint(str(tmp_path / "c"), p)
    assert torch.equal(back["w"], torch.arange(6.0))
    (tmp_path / "file").write_text("")
    bad = AsyncCheckpointer(str(tmp_path / "file" / "sub"), keep=1)
    bad.save(1, p)
    with pytest.raises(OSError):
        bad.wait()


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", "internlm2-1.8b", "--device", "cpu",
                              "--steps", "4", "--checkpoint-dir",
                              str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] {'steps': 4")
    first, last = lines[1].split("loss ")[1].split(" -> ")
    assert np.isfinite(float(first)) and np.isfinite(float(last))
    assert latest_step(str(tmp_path / "internlm2-1.8b-reduced")) == 4


def test_build_run_matches_jax(tmp_path):
    from repro.launch.train import build_run as jbuild

    for reduced in (True, False):
        got = launch_train.build_run("qwen3-8b", reduced=reduced, steps=20,
                                     checkpoint_dir=str(tmp_path))
        want = jbuild("qwen3-8b", reduced=reduced, steps=20,
                      checkpoint_dir=str(tmp_path))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _flag_trains_the_same_step(tmp_path, **flag):
    """Two steps with a ParallelConfig field set equal two without it,
    bit for bit: losses, parameters and AdamW state."""
    run, _ = _runs(tmp_path / "a")
    flagged_run = dataclasses.replace(
        run, parallel=dataclasses.replace(run.parallel, **flag),
        train=dataclasses.replace(run.train,
                                  checkpoint_dir=str(tmp_path / "b")))
    plain = Trainer(run, device="cpu")
    flagged = Trainer(flagged_run, device="cpu")
    plain.train(2)
    flagged.train(2)
    assert [m["loss"] for m in flagged.metrics_log] == [
        m["loss"] for m in plain.metrics_log]
    for a, b in zip(tree_leaves({"p": plain.params, "o": plain.opt_state}),
                    tree_leaves({"p": flagged.params,
                                 "o": flagged.opt_state})):
        assert torch.equal(a, b)


def test_collective_matmul_flag_trains_the_same_step(tmp_path):
    """``ParallelConfig.collective_matmul`` is read nowhere, in the JAX
    package too (its trainer trains the same step with it set)."""
    _flag_trains_the_same_step(tmp_path, collective_matmul=True)


def test_grad_compression_flag_trains_the_same_step(tmp_path):
    """``ParallelConfig.grad_compression`` is read nowhere, in the JAX
    package too (its trainer trains the same step with "int8_ef" set; the
    int8 codec serves ``core/reduction.py``'s staged all-reduce)."""
    _flag_trains_the_same_step(tmp_path, grad_compression="int8_ef")


def test_what_this_slice_does_not_train_raises(tmp_path):
    """A mesh axis that is neither DP nor TP raises, and so does ZeRO-3 on
    a TP mesh; every family trains on a TP mesh, and ``moe_a2a_chunks >
    1`` trains (without a "model" axis it is read nowhere), as do the
    recurrent families and remat "dots" (the loss of remat "none")."""
    run, _ = _runs(tmp_path)
    chunked = dataclasses.replace(run, parallel=dataclasses.replace(
        run.parallel, moe_a2a_chunks=2))
    t = Trainer(chunked, device="cpu")     # trained since
    t.train(1)
    assert np.isfinite(t.metrics_log[0]["loss"])
    tp = ProcessMesh(("data", "model"), (1, 2), 0, torch.device("cpu"))
    check_ported(run.parallel, tp)          # every family, moe since
    check_ported(chunked.parallel, tp)
    odd = ProcessMesh(("data", "expert"), (1, 2), 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_ported(run.parallel, odd)
    with pytest.raises(ValueError, match="param_shard"):
        check_ported(dataclasses.replace(run.parallel, param_shard=True), tp)
    for arch in ("mamba2-780m", "recurrentgemma-2b"):   # trained since
        rec = dataclasses.replace(run, model=get_arch(arch).reduced())
        t = Trainer(rec, device="cpu")
        t.train(1)
        assert np.isfinite(t.metrics_log[0]["loss"])
        assert np.isfinite(t.metrics_log[0]["grad_norm"])
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "targets": torch.zeros(1, 4, dtype=torch.long)}
    losses = [build_model(run.model, ModelOptions(remat=r)).train_loss(
        build_model(run.model).init(0, "cpu"), batch)
        for r in ("dots", "none")]       # trained since
    assert torch.equal(losses[0], losses[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(run)
