"""The VLM family (LLaVA-NeXT-34B's backbone, reduced: 4 layers, 16 stub
patches) of the port against the JAX package on the CPU: the prefill and
decode logits (the patches before the text, decode positions after both),
``train_loss`` and its gradients with the patch positions out of the loss,
three ``Trainer`` steps with the reference's float32 stub patches, the
layer provenance, and streaming ZeRO-3 on one rank against gathering all.
Tolerances as ``tests/_torch_frontend.py`` says.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from _torch_dist import zero3_trainer
from _torch_frontend import (logits_match_jax, param_layers_match_jax,
                             stub_of_trainer, train_batch,
                             train_loss_and_grads_match_jax,
                             trainer_matches_jax)
from _torch_jax import both_batches, both_models, f32

from repro_torch.config.registry import get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import ModelOptions, build_model

ARCH = "llava-next-34b"
PATCHES = 16


@pytest.mark.parametrize("dtype,scan", [("f32", True), ("f32", False),
                                        ("bf16", True)])
def test_prefill_and_decode_logits_match_jax(dtype, scan):
    """Prefill 12 tokens after 16 patches, then three decode steps at
    positions 28, 29, 30, against JAX; the ring holds patches and text."""
    tc, jc = logits_match_jax(ARCH, dtype, scan=scan)
    k = tc["k"] if scan else tc[0]["k"]
    assert k.shape[-3] == PATCHES + 12 + 3


def test_prefill_caches_hold_the_patches():
    """Without max_len the cache is the patches plus the prompt, as in the
    reference; the prefill's ring positions run over both."""
    jm, jp, tm, tp = both_models(ARCH, "f32", scan=False)
    toks = np.random.default_rng(3).integers(1, 256, (2, 7))
    jb, tb = both_batches(tm.cfg, toks)
    _, tc = tm.prefill(tp, tb)
    _, jc = jm.prefill(jp, jb)
    assert len(tc) == len(jc) == 4
    for t_layer, j_layer in zip(tc, jc):
        assert t_layer["k"].shape == tuple(j_layer["k"].shape) == (
            2, PATCHES + 7, 2, 32)
        np.testing.assert_array_equal(f32(t_layer["pos"]),
                                      np.arange(PATCHES + 7))
        np.testing.assert_array_equal(f32(t_layer["pos"]),
                                      f32(j_layer["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(f32(t_layer[key]), f32(j_layer[key]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat,fused", [("none", True), ("full", True),
                                         ("none", False)])
def test_train_loss_and_grads_match_jax(remat, fused):
    """float32 patches into the float32 model: the loss over the text
    positions only, and the gradients of every leaf (vision_proj's
    through the text's attention to the patches). On the unrolled draw,
    as the trainer tests draw: the scanned one takes fan_in = the layer
    count (ROADMAP.md Queue 3), and without qk-norm its 5.7x larger
    weights move float32 gradients past 1e-4 by rounding alone."""
    train_loss_and_grads_match_jax(ARCH, remat, fused, scan=False)


def test_loss_ignores_the_patch_positions():
    """train_loss is the cross-entropy of the text positions' logits: the
    unfused loss of the hidden states after the 16 patch positions, and
    the targets hold text only; the patches still move it (they are
    attended to)."""
    _, _, tm, tp = both_models(ARCH, "f32", attn_impl="dense")
    _, tb = train_batch(tm.cfg)
    loss = float(tm.train_loss(tp, tb))
    x, _, _ = tm._forward(tp, tb, "train")
    assert x.shape[1] == PATCHES + tb["targets"].shape[1]
    np.testing.assert_allclose(
        loss, float(tm._xent(tp, x[:, PATCHES:], tb["targets"])), rtol=1e-6)
    other = dict(tb, patches=tb["patches"] * 3.0)
    assert abs(float(tm.train_loss(tp, other)) - loss) > 1e-4


def test_trainer_matches_jax(tmp_path):
    """Three steps against the JAX Trainer from the same parameters; both
    feed the reference's stub patches, constant 0.02 in float32."""
    t, jt = trainer_matches_jax(tmp_path, ARCH)
    port, ref, dtype = stub_of_trainer(t, jt)
    assert dtype == torch.float32
    np.testing.assert_array_equal(port, ref)
    assert port.shape == (4, PATCHES, 128)


@pytest.mark.parametrize("scan", [True, False])
def test_param_layers_match_jax(scan):
    """embed and vision_proj at 0, the stack 1..4 (one depth scanned),
    the head at 5."""
    got = param_layers_match_jax(ARCH, scan)
    assert got[("embed",)] == got[("vision_proj",)] == 0
    assert got[("final_norm",)] == got[("lm_head",)] == 5


def test_params_from_jax_needs_vision_proj():
    jm, jp, tm, _ = both_models(ARCH, "f32")
    tree = dict(jax.tree.map(np.asarray, jp))
    del tree["vision_proj"]
    with pytest.raises(ValueError, match="missing leaves.*vision_proj"):
        params_from_jax(tree, tm.cfg, tm.opt, "cpu")


def test_streaming_zero3_equals_gathering_all():
    """On one rank, bf16, 2 steps, the reference's stub patches: streaming
    ZeRO-3 (the patch projection gathered with the embedding's bucket)
    and gathering all on the same per-layer layout give the same losses,
    grad norms, flat params and moments, bit for bit; the first loss
    equals the replicated trainer's with the same options."""
    spec = dict(arch=ARCH, steps=2, global_batch=2, seq_len=16, lr=5e-3,
                dtype="bf16")
    mesh = make_mesh((1,), ("data",), "cpu")
    runs = {}
    for case in ("stream", "gather", "repl"):
        t = zero3_trainer(spec, case, None if case == "repl" else mesh,
                          "cpu")
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
    assert np.isfinite(s.metrics_log[-1]["loss"])


def test_the_reference_trains_and_serves_the_family_where_the_port_does():
    """build_model builds the full and the reduced config; train_loss and
    the streamed loss take it (the encoder-decoder's streamed loss
    refuses, tests/test_torch_encdec.py)."""
    for cfg in (get_arch(ARCH), get_arch(ARCH).reduced()):
        model = build_model(cfg, ModelOptions(scan_layers=False))
        assert model.param_specs()["vision_proj"].shape == (cfg.d_model,
                                                            cfg.d_model)
    assert get_arch(ARCH).num_params() == 34_388_049_920
