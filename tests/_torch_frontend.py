"""Checks shared by the port-vs-JAX tests of the two families with a stub
frontend input, the encoder-decoder (``tests/test_torch_encdec.py``) and
the VLM (``tests/test_torch_vlm.py``): logits of prefill and decode,
``train_loss`` and its gradients, three ``Trainer`` steps and the layer
provenance, each on one numpy-drawn tree loaded into both packages
(``_torch_jax.py``).

Tolerances: float32 1e-4 (logits), rtol 1e-4 (losses, gradients and
parameters, relative to each leaf's largest entry). In bf16 an entry may
also lie as far from JAX's as JAX's own bf16 logits lie from its float32
ones at their worst (``tests/test_torch_models.py``'s rule).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_jax import (both_batches, both_models, f32, frontend_stub,
                        jitted, numpy_params)

from repro.config.base import ParallelConfig as JaxParallel
from repro.config.base import RunConfig as JaxRun
from repro.config.base import TrainConfig as JaxTrain
from repro.config.registry import get_arch as jax_arch
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.config import ParallelConfig, RunConfig, TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.core.overlap import value_and_grad
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.models.model import ModelOptions
from repro_torch.runtime.trainer import Trainer

TOL = {"f32": (1e-4, 1e-4), "bf16": (3e-2, 6e-2)}


def decode_start(cfg, plen: int) -> int:
    """The first decode position after a prompt of `plen` tokens."""
    return plen + (cfg.num_vision_patches if cfg.family == "vlm" else 0)


def logits_match_jax(arch, dtype="f32", stub_dtype=None, scan=True, s=12,
                     attn_impl="flash"):
    """Prefill `s` tokens of 2 prompts with the stub frontend input (in
    `stub_dtype`, default the model's), then three decode steps: the port's
    logits against JAX's (flash: the plain version and JAX's oracle on the
    CPU). Returns the port's and JAX's caches after the steps."""
    jm, jp, tm, tp = both_models(arch, dtype, attn_impl=attn_impl,
                                 scan=scan)
    cfg = tm.cfg
    runs = [(jitted(jm), jp)]
    if dtype == "bf16":  # the reference's own bf16 error, in float32
        j32 = jax_build(jm.cfg, dataclasses.replace(jm.opt,
                                                    dtype=jnp.float32))
        runs.append((jitted(j32),
                     jax.tree.map(lambda a: a.astype(jnp.float32), jp)))
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, s + 3))
    start = decode_start(cfg, s)
    max_len = start + 3
    jb, tb = both_batches(cfg, toks[:, :s], dtype, stub_dtype=stub_dtype)
    jb32, _ = both_batches(cfg, toks[:, :s], "f32")

    def check(tl, jax_logits):
        want = f32(jax_logits[0])
        rtol, atol = TOL[dtype]
        bound = atol + rtol * np.abs(want)
        if len(jax_logits) > 1:
            bound = np.maximum(bound, np.abs(want - f32(jax_logits[1])).max())
        err = np.abs(f32(tl) - want)
        assert np.all(err <= bound), err.max()

    tl, tc = tm.prefill(tp, tb, max_len=max_len)
    outs = [fns[0](p, b, max_len=max_len)
            for (fns, p), b in zip(runs, (jb, jb32))]
    check(tl, [o[0] for o in outs])
    caches = [o[1] for o in outs]
    for n in range(3):
        tok = toks[:, s + n:s + n + 1]
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, start + n)
        outs = [fns[1](p, jnp.asarray(tok, jnp.int32), c,
                       jnp.asarray(start + n, jnp.int32))
                for (fns, p), c in zip(runs, caches)]
        check(tl, [o[0] for o in outs])
        caches = [o[1] for o in outs]
    return tc, caches[0]


def train_batch(cfg, b=2, s=16, seed=3, stub_dtype="f32"):
    """(JAX batch, port batch): next-token targets of random tokens, with
    the stub frontend input in `stub_dtype`."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    return both_batches(cfg, toks[:, :-1], targets=toks[:, 1:],
                        stub_dtype=stub_dtype)


def train_loss_and_grads_match_jax(arch, remat="none", fused=True,
                                   scan=True):
    """train_loss and its gradients, float32, against JAX's at rtol 1e-4
    (dense attention, the trainer's). Returns the port's loss."""
    jm, jp, tm, tp = both_models(arch, "f32", attn_impl="dense", scan=scan)
    jm = jax_build(jm.cfg, dataclasses.replace(jm.opt, fused_xent=fused))
    tm.opt = dataclasses.replace(tm.opt, remat=remat, fused_xent=fused)
    jb, tb = train_batch(tm.cfg)
    tp.requires_grad_(True)
    loss, grads = value_and_grad(tm.train_loss)(tp, tb)
    want_loss, want = jax.jit(jax.value_and_grad(jm.train_loss))(jp, jb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    got = leaf_paths(grads)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for (path, g), w in zip(got.items(), want):
        w = f32(w)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(f32(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))
    return float(loss)


def trainer_matches_jax(tmp_path, arch, steps=3, accum=1):
    """`steps` steps of the port's Trainer and the JAX Trainer (no mesh,
    unrolled, float32, remat "none", the reference's float32 stub frontend
    inputs) from the same parameters: losses, grad norms, learning rates
    and final parameters at rtol 1e-4."""
    train = dict(global_batch=4, seq_len=16, lr=5e-3, warmup_steps=2,
                 total_steps=steps, checkpoint_every=100,
                 checkpoint_dir=str(tmp_path / "ckpt"), seed=3)
    par = dict(remat="none", accum_steps=accum, scan_layers=False)
    run = RunConfig(model=get_arch(arch).reduced(),
                    parallel=ParallelConfig(**par), train=TrainConfig(**train))
    jrun = JaxRun(model=jax_arch(arch).reduced(),
                  parallel=JaxParallel(**par), train=JaxTrain(**train))
    jopts = JaxOptions(dtype=jnp.float32, scan_layers=False)
    tree = numpy_params(jax_build(jrun.model, jopts))
    jt = JaxTrainer(jrun, options=jopts)
    jt.init_state()
    jt.params = jax.tree.map(jnp.asarray, tree)
    jt.opt_state = jadamw_init(jt.params)
    jt.train(steps)
    opts = ModelOptions(dtype=torch.float32, scan_layers=False)
    t = Trainer(run, options=opts, device="cpu")
    t.init_state(params=params_from_jax(tree, run.model, opts, "cpu"))
    t.train(steps)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in t.metrics_log],
                                   [m[key] for m in jt.metrics_log],
                                   rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jt.params), run.model,
                           opts, "cpu")
    for got, w in zip(tree_leaves(t.params), tree_leaves(want)):
        np.testing.assert_allclose(f32(got), f32(w), rtol=1e-4,
                                   atol=1e-4 * np.abs(f32(w)).max())
    return t, jt


def stub_of_trainer(t, jt):
    """The stub frontend inputs the two Trainers feed on their first step:
    (port, JAX), numpy."""
    port = t._place_batch(0)
    jax_b = jt._augment_frontend(jt.data.batch_at(0))
    key = frontend_stub(t.run.model, 1)[0]
    return f32(port[key]), np.asarray(jax_b[key]), port[key].dtype


def param_layers_match_jax(arch, scan):
    """Layer provenance leaf for leaf, path and depth, against JAX's."""
    jm, _, tm, _ = both_models(arch, "f32", attn_impl="dense", scan=scan)
    got = leaf_paths(tm.param_layers())
    want = jax.tree_util.tree_flatten_with_path(jm.param_layers())[0]
    assert len(got) == len(want)
    for (path, depth), (jpath, jdepth) in zip(got.items(), want):
        assert [str(p) for p in path] == [
            str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath]
        assert depth == jdepth, path
    return got
