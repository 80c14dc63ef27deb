"""The encoder-decoder family (Whisper-base, reduced: 2 encoder and 4
decoder layers, 64 frames) of the port against the JAX package on the CPU:
LayerNorm and the sinusoid, cross-attention and its keys and values, the
prefill and decode logits, ``train_loss`` and its gradients, three
``Trainer`` steps with the reference's float32 stub frames, the layer
provenance, the parameter conversion, and where both packages refuse the
family. Four facts of the reference that the port keeps are pinned here in
both packages (``ROADMAP.md`` Queue 3): the encoder is causal and roped; a
decode step embeds the sinusoid of position 0; float32 frames carry the
encoder in float32; the streaming ZeRO-3 loss refuses the family.

Tolerances: the layers at float32 1e-6; the rest as
``tests/_torch_frontend.py`` says.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_frontend import (logits_match_jax, param_layers_match_jax,
                             stub_of_trainer, train_loss_and_grads_match_jax,
                             trainer_matches_jax)
from _torch_jax import both_batches, both_models, f32

from repro.config.registry import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.config.registry import get_arch
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import ModelOptions, build_model

ARCH = "whisper-base"


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- layers
def test_layer_norm_and_sinusoid_match_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0) + 1.5
    w, b = _rand(rng, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        f32(layers.layer_norm(_t(x), _t(w), _t(b), 1e-6)),
        f32(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), 1e-6)),
        rtol=1e-6, atol=1e-6)
    got = layers.layer_norm(_t(x).to(torch.bfloat16), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    # against the reference as its models run it, compiled (its eager exp
    # is off the correctly rounded value by an ulp for some frequencies)
    sinusoid = jax.jit(jlayers.sinusoidal_embedding, static_argnums=(0, 1))
    for seq, dim in ((1, 64), (64, 128), (1500, 512)):
        s = layers.sinusoidal_embedding(seq, dim)
        assert s.dtype == torch.float32 and s.shape == (seq, dim)
        np.testing.assert_allclose(f32(s), f32(sinusoid(seq, dim)),
                                   rtol=1e-6, atol=1e-6)
    # sin on the even columns, cos on the odd: row 0 is (0, 1, 0, 1, ...)
    np.testing.assert_array_equal(f32(layers.sinusoidal_embedding(1, 6)),
                                  [[0, 1, 0, 1, 0, 1]])


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_and_its_kv_match_jax(qk_norm):
    """encode_cross_kv and cross_attention (no rope, no mask over the
    encoder's keys, GQA 4/2) in float32, and with float32 keys under bf16
    queries (the trainer's f32 frames): the output in the queries'
    dtype."""
    import dataclasses

    cfg = dataclasses.replace(get_arch(ARCH).reduced(), qk_norm=qk_norm)
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), qk_norm=qk_norm)
    rng = np.random.default_rng(1)
    p = {k: _rand(rng, *s.shape, scale=0.1) + (1.0 if "norm" in k else 0.0)
         for k, s in attn.cross_attention_specs(cfg, torch.float32).items()}
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    enc = _rand(rng, 2, 64, cfg.d_model)
    x = _rand(rng, 2, 5, cfg.d_model)
    tkv = attn.encode_cross_kv(tp, _t(enc), cfg)
    jkv = jattn.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        f32(attn.cross_attention(tp, _t(x), tkv, cfg)),
        f32(jattn.cross_attention(jp, jnp.asarray(x), jkv, jcfg)),
        rtol=1e-6, atol=1e-6)
    # bf16 weights and queries, f32 encoder output: f32 keys, bf16 output
    tpb = {k: v.to(torch.bfloat16) if "norm" not in k else v
           for k, v in tp.items()}
    jpb = {k: v.astype(jnp.bfloat16) if "norm" not in k else v
           for k, v in jp.items()}
    tkv = attn.encode_cross_kv(tpb, _t(enc), cfg)
    jkv = jattn.encode_cross_kv(jpb, jnp.asarray(enc), jcfg)
    assert tkv[0].dtype == torch.float32 and jkv[0].dtype == jnp.float32
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)
    xb = _t(x).to(torch.bfloat16)
    got = attn.cross_attention(tpb, xb, tkv, cfg)
    want = jattn.cross_attention(jpb, jnp.asarray(x, jnp.bfloat16), jkv,
                                 jcfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------- prefill and decode
@pytest.mark.parametrize("dtype,stub", [("f32", None), ("bf16", None),
                                        ("bf16", "f32")])
def test_prefill_and_decode_logits_match_jax(dtype, stub):
    """Prefill 12 tokens with 64 frames, then three decode steps, against
    JAX; bf16 frames in the bf16 model (as the JAX suite serves it), and
    float32 frames there too (the trainer's stubs: the encoder, its output
    and the cross-attention keys run in float32, in both packages). The
    decode caches hold the prefill's cross keys and values unchanged, in
    the dtype JAX's do."""
    tc, jc = logits_match_jax(ARCH, dtype, stub_dtype=stub)
    want = torch.float32 if "f32" in (dtype, stub) else torch.bfloat16
    for t_layer, j_layer in zip(tc, jc):
        assert sorted(t_layer) == sorted(j_layer) == ["cross_k", "cross_v",
                                                      "self"]
        for key in ("cross_k", "cross_v"):
            assert t_layer[key].dtype == want
            assert str(j_layer[key].dtype) == str(want).split(".")[1]
            np.testing.assert_allclose(f32(t_layer[key]), f32(j_layer[key]),
                                       rtol=3e-2 if dtype == "bf16" else 1e-5,
                                       atol=3e-2 if dtype == "bf16" else 1e-5)


def test_decode_step_leaves_the_cross_caches_unchanged():
    _, _, tm, tp = both_models(ARCH, "f32")
    toks = np.random.default_rng(4).integers(1, 256, (2, 9))
    _, tb = both_batches(tm.cfg, toks[:, :6])
    _, caches = tm.prefill(tp, tb, max_len=9)
    kept = [{k: c[k].clone() for k in ("cross_k", "cross_v")} for c in caches]
    for n in range(6, 9):
        _, caches = tm.decode_step(tp, _t(toks[:, n:n + 1]), caches, n)
    for c, k in zip(caches, kept):
        assert torch.equal(c["cross_k"], k["cross_k"])
        assert torch.equal(c["cross_v"], k["cross_v"])


def test_encoder_is_causal_and_roped_in_both_packages():
    """The reference's encoder layers are the "attn" block: causal
    self-attention with rope (published Whisper's is bidirectional and
    unroped; ROADMAP.md Queue 3). In both packages: the encoder's output
    at frame t does not move when the frames after t do, and it moves when
    rope is taken out."""
    jm, jp, tm, tp = both_models(ARCH, "f32")
    rng = np.random.default_rng(5)
    frames = _rand(rng, 2, 64, tm.cfg.d_model, scale=0.02)
    later = frames.copy()
    later[:, 40:] = _rand(rng, 2, 24, tm.cfg.d_model, scale=0.02)
    t0, t1 = (f32(tm._encode(tp, _t(f))) for f in (frames, later))
    j0, j1 = (f32(jm._encode(jp, jnp.asarray(f))) for f in (frames, later))
    for a, b in ((t0, t1), (j0, j1)):
        np.testing.assert_array_equal(a[:, :40], b[:, :40])
        assert np.abs(a[:, 40:] - b[:, 40:]).max() > 1e-3
    np.testing.assert_allclose(t0, j0, rtol=1e-5, atol=1e-5)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(attn, "apply_rope", lambda x, pos, theta: x)
        mp.setattr(jattn, "apply_rope", lambda x, pos, theta: x)
        t_plain = f32(tm._encode(tp, _t(frames)))
        j_plain = f32(jm._encode(jp, jnp.asarray(frames)))
    finally:
        mp.undo()
    np.testing.assert_allclose(t_plain, j_plain, rtol=1e-5, atol=1e-5)
    assert np.abs(t_plain - t0).max() > 1e-3


def test_decode_embeds_the_sinusoid_of_position_zero_as_jax():
    """A decode step adds row 0 of the sinusoid whatever its position
    (the reference takes ``tokens.shape[1]`` rows): so prefill then decode
    is not the full forward, in both packages (ROADMAP.md Queue 3), and
    the port's decode logits are JAX's."""
    jm, jp, tm, tp = both_models(ARCH, "f32")
    cfg = tm.cfg
    tok = _t(np.array([[7], [9]]))
    got = tm._embed(tp, tok)
    plain = torch.nn.functional.embedding(tok, tp["embed"])
    row0 = layers.sinusoidal_embedding(1, cfg.d_model)
    np.testing.assert_allclose(f32(got), f32((plain + row0) * cfg.d_model
                                             ** 0.5), rtol=1e-6)
    toks = np.random.default_rng(6).integers(1, 256, (2, 9))
    jb, tb = both_batches(cfg, toks)
    full_t, _ = tm.prefill(tp, tb)
    full_j, _ = jm.prefill(jp, jb)
    jb8, tb8 = both_batches(cfg, toks[:, :8])
    _, tc = tm.prefill(tp, tb8, max_len=9)
    _, jc = jm.prefill(jp, jb8, max_len=9)
    step_t, _ = tm.decode_step(tp, _t(toks[:, 8:]), tc, 8)
    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, 8:], jnp.int32), jc,
                               jnp.asarray(8, jnp.int32))
    np.testing.assert_allclose(f32(step_t), f32(step_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f32(full_t), f32(full_j), rtol=1e-4,
                               atol=1e-4)
    for step, full in ((step_t, full_t), (step_j, full_j)):
        assert np.abs(f32(step) - f32(full)).max() > 1e-2


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("remat,fused", [("none", True), ("full", True),
                                         ("none", False)])
def test_train_loss_and_grads_match_jax(remat, fused):
    """Float32 frames into the float32 model; fused and unfused loss,
    remat "full" (the decoder layers recomputed, enc_out read by each
    through the checkpoint)."""
    train_loss_and_grads_match_jax(ARCH, remat, fused)


def test_trainer_matches_jax(tmp_path):
    """Three steps against the JAX Trainer from the same parameters; both
    feed the reference's stub frames, constant 0.02 in float32."""
    t, jt = trainer_matches_jax(tmp_path, ARCH)
    port, ref, dtype = stub_of_trainer(t, jt)
    assert dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(port, ref)
    assert port.shape == (4, 64, 128) and np.all(port == np.float32(0.02))


def test_param_layers_match_jax():
    """embed and audio_proj at 0, the encoder's layers at 1..2, enc_norm
    at 3, the decoder's at 4..7, final_norm at 8: the grad-bucket schedule
    issues the decoder's buckets before the encoder's."""
    got = param_layers_match_jax(ARCH, scan=True)
    assert got[("embed",)] == got[("audio_proj",)] == 0
    assert got[("encoder", 0, "attn", "wq")] == 1
    assert got[("encoder", 1, "norm2_b")] == 2
    assert got[("enc_norm",)] == got[("enc_norm_b",)] == 3
    assert got[("layers", 0, "cross", "wk")] == 4
    assert got[("layers", 3, "norm_cross_b")] == 7
    assert got[("final_norm",)] == got[("final_norm_b",)] == 8


def test_params_from_jax_carries_every_leaf_and_rejects_a_bad_tree():
    jm, jp, tm, tp = both_models(ARCH, "bf16")
    assert isinstance(tp["layers"], torch.nn.ModuleList)   # never uniform
    assert tp["encoder"][1]["norm1_b"].dtype == torch.float32
    assert tp["layers"][0]["cross"]["wq"].dtype == torch.bfloat16
    assert tp["audio_proj"].shape == (128, 128)
    tree = jax.tree.map(np.asarray, jp)
    for drop in (("encoder", 0, "norm1_b"), ("layers", 2, "cross", "wv"),
                 ("enc_norm_b",), ("audio_proj",)):
        bad = jax.tree.map(lambda a: a, tree)
        node = bad
        for key in drop[:-1]:
            node = node[key]
        del node[drop[-1]]
        with pytest.raises(ValueError, match=f"missing leaves.*{drop[-1]}"):
            params_from_jax(bad, tm.cfg, tm.opt, "cpu")
    bad = dict(tree, vision_proj=np.zeros((128, 128), np.float32))
    with pytest.raises(ValueError, match="unexpected leaves.*vision_proj"):
        params_from_jax(bad, tm.cfg, tm.opt, "cpu")


def test_cache_specs_match_jax():
    """Per decoder layer: the self-attention ring and the (b, enc_seq,
    kv heads, head dim) cross keys and values."""
    cfg = get_arch(ARCH).reduced()
    specs = build_model(cfg).cache_specs(3, 40)
    jspecs = jtfm.stack_cache_specs(jax_arch(ARCH).reduced(), 3, 40, True)
    assert len(specs) == len(jspecs) == cfg.num_layers
    for s, j in zip(specs, jspecs):
        assert s["cross_k"].shape == tuple(j["cross_k"].shape) == (
            3, 64, 2, 32)
        assert s["self"]["k"].shape == tuple(j["self"]["k"].shape)
    full = build_model(get_arch(ARCH))                   # published widths
    assert len(full.param_specs()["encoder"]) == 6
    assert full.cache_specs(8, 448)[5]["cross_v"].shape == (8, 1500, 8, 64)


def test_streamed_loss_refuses_the_family_as_jax():
    """train_loss_streamed raises ValueError for the encoder-decoder (its
    encoder's output is read by every decoder layer), after the scanned
    stack's own ValueError, as in the reference; the TP decode step
    refuses the family in both packages."""
    from repro.models.decode_tp import build_decode_step as jbuild_tp
    from repro.launch.mesh import make_mesh as jmesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.decode_tp import build_decode_step

    cfg = get_arch(ARCH).reduced()
    for scan, match in ((True, "unrolled stack"), (False, "decoder-only")):
        model = build_model(cfg, ModelOptions(scan_layers=scan))
        with pytest.raises(ValueError, match=match):
            model.train_loss_streamed({}, {}, None)
    with pytest.raises(ValueError, match="dense family"):
        build_decode_step(build_model(cfg), make_mesh((1, 1),
                                                      ("data", "model"),
                                                      "cpu"))
    jm, _, _, _ = both_models(ARCH, "f32")
    with pytest.raises(ValueError, match="dense family"):
        jbuild_tp(jm, jmesh((1, 1), ("data", "model")))
