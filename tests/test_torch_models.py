"""The port's models against the JAX package on the CPU: layers, attention
prefill/decode, and prefill/decode_step logits of reduced configs (dense
GQA, MoE, Mamba-2, RecurrentGemma; the encoder-decoder and VLM families
in ``test_torch_encdec.py`` and ``test_torch_vlm.py``), with one
numpy-drawn parameter tree
loaded into both (``_torch_jax.py``).

Tolerances: float32 1e-4 (the two frameworks order float32 sums
differently; logits here are O(1)); bf16 the JAX suite's own 3e-2 / 6e-2
(``tests/test_models.py``), since the frameworks round bf16 at other places.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import both_models, f32, jitted

from repro.config.registry import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import ParamTree, init_from_specs, leaf_seed
from repro_torch.models.model import ModelOptions, build_model

TOL = {"f32": (1e-4, 1e-4), "bf16": (3e-2, 6e-2)}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_configs_are_the_reference_configs():
    from repro.config.registry import list_archs as jax_list

    assert list_archs() == jax_list()
    for arch in list_archs():
        assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(
            jax_arch(arch))
        assert dataclasses.asdict(get_arch(arch).reduced()) == \
            dataclasses.asdict(jax_arch(arch).reduced())


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 3, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        f32(layers.rms_norm(_t(x), _t(w), 1e-6)),
        f32(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [7]])
    np.testing.assert_allclose(
        f32(layers.apply_rope(_t(x), _t(pos), 1e6)),
        f32(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    h = _rand(rng, 2, 5, 64)
    p = {"gate": _rand(rng, 64, 96, scale=0.1), "up": _rand(rng, 64, 96, scale=0.1),
         "down": _rand(rng, 96, 64, scale=0.1)}
    np.testing.assert_allclose(
        f32(layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(h))),
        f32(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


_jax_prefill = jax.jit(jattn.prefill_attention, static_argnums=(2, 5, 6))
_jax_decode = jax.jit(jattn.decode_attention, static_argnums=(2, 5))


@pytest.mark.parametrize("window", [None, 6])
def test_attention_prefill_and_decode_match_jax(window):
    """prefill_attention (dense and flash; ring placement when the prompt
    overflows the ring) and decode_attention with a scalar and a per-slot
    position, against the JAX package in float32."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              sliding_window=window)
    jcfg = dataclasses.replace(jax_arch("qwen3-8b").reduced(),
                               sliding_window=window)
    rng = np.random.default_rng(1)
    p = {k: _rand(rng, *s.shape, scale=0.1)
         for k, s in attn.attention_specs(cfg, torch.float32).items()}
    tp, jp = ({k: _t(v) for k, v in p.items()},
              {k: jnp.asarray(v) for k, v in p.items()})
    b, s = 2, 9
    x = _rand(rng, b, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s), (b, s))
    for w, impl in ((16, "dense"), (16, "flash"), (8, "flash")):
        tc = attn.make_cache(cfg, b, w, torch.float32, "cpu")
        jc = jattn.make_cache(jcfg, b, w, jnp.float32)
        ty, tc = attn.prefill_attention(tp, _t(x), cfg, _t(pos), tc, impl,
                                        window)
        jy, jc = _jax_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), jc,
                              impl, window)
        np.testing.assert_allclose(f32(ty), f32(jy), rtol=1e-5, atol=1e-5)
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(f32(tc[key]), f32(jc[key]),
                                       rtol=1e-5, atol=1e-5)
        xt = _rand(rng, b, 1, cfg.d_model)
        ty, tc = attn.decode_attention(tp, _t(xt), cfg, tc, s, window)
        jy, jc = _jax_decode(jp, jnp.asarray(xt), jcfg, jc,
                             jnp.asarray(s, jnp.int32), window)
        np.testing.assert_allclose(f32(ty), f32(jy), rtol=1e-5, atol=1e-5)
    # per-slot positions on a per-slot (b, w) ring
    tc = {k: torch.zeros(b, 16, cfg.num_kv_heads, 32) for k in ("k", "v")}
    ring = np.full((b, 16), -1)
    ring[0, :5], ring[1, :3] = np.arange(5), np.arange(3)
    kv = _rand(rng, 2, b, 16, cfg.num_kv_heads, 32)
    tc = {"k": _t(kv[0]), "v": _t(kv[1]), "pos": _t(ring)}
    jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
          "pos": jnp.asarray(ring, jnp.int32)}
    xt = _rand(rng, b, 1, cfg.d_model)
    slot_pos = np.array([5, 3])
    ty, tc = attn.decode_attention(tp, _t(xt), cfg, tc, _t(slot_pos), window)
    jy, jc = _jax_decode(jp, jnp.asarray(xt), jcfg, jc,
                         jnp.asarray(slot_pos, jnp.int32), window)
    np.testing.assert_allclose(f32(ty), f32(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(f32(tc["pos"]), f32(jc["pos"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "internlm2-1.8b",
                                  "granite-3-2b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_prefill_and_decode_logits_match_jax(arch, dtype):
    """prefill then three decode steps, port (flash: the plain version on
    the CPU) against JAX's attn_impl="flash" (its ref oracle on the CPU).

    bf16 rounds at other places in the two frameworks (XLA's CPU expansion
    of sigmoid rounds each of its steps to bf16, so a third of the silu
    outputs differ by one ulp), and the models without qk-norm amplify such
    flips through their layers. So in bf16 an entry may also lie as far from
    JAX's as JAX's own bf16 logits lie from its float32 logits (on the same
    bf16-rounded parameters) at their worst, where that is more than the
    JAX suite's 3e-2 / 6e-2."""
    _logits_match_jax(arch, dtype, scan=True, s=24)


def _logits_match_jax(arch, dtype, scan, s):
    """Prefill `s` tokens of 2 prompts, then three decode steps, port
    against JAX (the bf16 rule of the test above)."""
    jm, jp, tm, tp = both_models(arch, dtype, scan=scan)
    runs = [(jitted(jm), jp)]
    if dtype == "bf16":  # the reference's own bf16 error, in float32
        runs.append((jitted(jax_build_like(jm, jnp.float32)),
                     jax.tree.map(lambda a: a.astype(jnp.float32), jp)))
    rng = np.random.default_rng(2)
    b, max_len = 2, s + 3
    toks = rng.integers(1, tm.cfg.vocab_size, (b, s + 3))

    def check(tl, jax_logits):
        want = f32(jax_logits[0])
        rtol, atol = TOL[dtype]
        bound = atol + rtol * np.abs(want)
        if len(jax_logits) > 1:
            bound = np.maximum(bound, np.abs(want - f32(jax_logits[1])).max())
        assert np.all(np.abs(f32(tl) - want) <= bound), \
            np.abs(f32(tl) - want).max()

    prompt = jnp.asarray(toks[:, :s], jnp.int32)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :s])}, max_len=max_len)
    outs = [fns[0](p, {"tokens": prompt}, max_len=max_len) for fns, p in runs]
    check(tl, [o[0] for o in outs])
    caches = [o[1] for o in outs]
    for n in range(s, s + 3):
        tok = toks[:, n:n + 1]
        tl, tc = tm.decode_step(tp, _t(tok), tc, n)
        outs = [fns[1](p, jnp.asarray(tok, jnp.int32), c,
                       jnp.asarray(n, jnp.int32))
                for (fns, p), c in zip(runs, caches)]
        check(tl, [o[0] for o in outs])
        caches = [o[1] for o in outs]


def jax_build_like(jax_model, dtype):
    from repro.models.model import build_model as jax_build

    return jax_build(jax_model.cfg, dataclasses.replace(jax_model.opt,
                                                        dtype=dtype))


@pytest.mark.parametrize("arch,scan", [("qwen3-moe-30b-a3b", True),
                                       ("qwen3-moe-30b-a3b", False),
                                       ("mixtral-8x7b", False)])
def test_moe_logits_match_jax_past_the_window(arch, scan):
    """The MoE family (capacity dispatch: E=4, top-2, C = ceil(0.625 S),
    so experts overflow and drop tokens), 80-token prompts, past reduced
    Mixtral's 64-token window (its ring wraps), f32 at 1e-4.

    Mixtral is held on the unrolled draw: the scanned one (fan_in = the
    layer count, ROADMAP.md Queue 3) gives it, without qk-norm, query and
    key weights 5.7x larger, and f32 rounding alone then moves its logits
    by up to 8e-4 (no routing decision differs: each layer's top-2 was
    checked against JAX's on the same inputs). bf16 is held at the block
    (tests/test_torch_moe.py): through a whole model the two frameworks'
    bf16 roundings flip 1-3 of these 160 tokens' routing in layers 1-3,
    a different function, not a rounding error."""
    _logits_match_jax(arch, "f32", scan=scan, s=80)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_params_from_jax_in_both_layouts(arch):
    """params_from_jax carries the moe subtree (router in f32, experts in
    the model dtype) from either JAX layout into either port layout, and
    the port's scanned and unrolled models then give the same logits bit
    for bit, within 1e-4 of JAX's."""
    jm_u, jp_u, tm_u, tp_u = both_models(arch, "f32", scan=False)
    cfg, m = tm_u.cfg, tm_u.cfg.moe
    scan_opt = ModelOptions(attn_impl="flash", dtype=torch.float32)
    ts = params_from_jax(jax.tree.map(np.asarray, jp_u), cfg, scan_opt,
                         "cpu")
    moe = ts["layers"]["moe"]
    assert moe["router"].shape == (4, cfg.d_model, m.num_experts)
    assert moe["gate"].shape == (4, m.num_experts, cfg.d_model,
                                 m.d_ff_expert)
    assert moe["down"].shape == (4, m.num_experts, m.d_ff_expert,
                                 cfg.d_model)
    assert "mlp" not in ts["layers"]
    toks = _t(np.random.default_rng(4).integers(1, 256, (2, 30)))
    want, _ = tm_u.prefill(tp_u, {"tokens": toks})
    got, _ = build_model(cfg, scan_opt).prefill(ts, {"tokens": toks})
    np.testing.assert_array_equal(f32(got), f32(want))
    jl, _ = jitted(jm_u)[0](jp_u, {"tokens": jnp.asarray(toks.numpy(),
                                                          jnp.int32)})
    np.testing.assert_allclose(f32(got), f32(jl), rtol=1e-4, atol=1e-4)
    # the scanned JAX draw into the unrolled layout, and bf16
    _, jp_s, tm_s, tp_s = both_models(arch, "f32", scan=True)
    unrolled = ModelOptions(attn_impl="flash", dtype=torch.float32,
                            scan_layers=False)
    tu = params_from_jax(jax.tree.map(np.asarray, jp_s), cfg, unrolled,
                         "cpu")
    want, _ = tm_s.prefill(tp_s, {"tokens": toks})
    got, _ = build_model(cfg, unrolled).prefill(tu, {"tokens": toks})
    np.testing.assert_array_equal(f32(got), f32(want))
    bf = params_from_jax(jax.tree.map(np.asarray, jp_s), cfg,
                         ModelOptions(dtype=torch.bfloat16), "cpu")
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["gate"].dtype == torch.bfloat16


def test_scanned_and_unrolled_layouts_agree():
    """The unrolled port model equals the scanned one, from a JAX tree in
    either layout; a scanned JAX tree converts to the unrolled layout and
    back."""
    jm, jp, tm, tp = both_models("qwen3-8b", "f32", scan=True)
    tree = jax.tree.map(np.asarray, jp)
    unrolled_opt = ModelOptions(attn_impl="flash", dtype=torch.float32,
                                scan_layers=False)
    tu = params_from_jax(tree, tm.cfg, unrolled_opt, "cpu")
    assert isinstance(tu["layers"], torch.nn.ModuleList)
    tm_u = build_model(tm.cfg, unrolled_opt)
    jm_u, jp_u, _, tu2 = both_models("qwen3-8b", "f32", scan=False)
    toks = _t(np.random.default_rng(3).integers(1, 256, (1, 12)))
    want, _ = tm.prefill(tp, {"tokens": toks})
    got, _ = tm_u.prefill(tu, {"tokens": toks})
    np.testing.assert_array_equal(f32(got), f32(want))
    # an unrolled JAX tree into the scanned layout
    back = params_from_jax(jax.tree.map(np.asarray, jp_u), tm.cfg, tm.opt,
                           "cpu")
    got2, _ = tm.prefill(back, {"tokens": toks})
    want2, _ = tm_u.prefill(tu2, {"tokens": toks})
    np.testing.assert_array_equal(f32(got2), f32(want2))
    jl, _ = jitted(jm_u)[0](jp_u, {"tokens": jnp.asarray(toks.numpy(),
                                                          jnp.int32)})
    np.testing.assert_allclose(f32(got2), f32(jl), rtol=1e-4, atol=1e-4)


def test_embed_scale_is_rounded_to_the_activation_dtype():
    cfg = get_arch("qwen3-8b").reduced()                 # d_model 128
    model = build_model(cfg, ModelOptions(dtype=torch.bfloat16))
    params = {"embed": torch.ones(4, 128, dtype=torch.bfloat16)}
    x = model._embed(params, torch.tensor([[1, 2]]))
    assert x.dtype == torch.bfloat16
    assert float(x[0, 0, 0]) == 11.3125                   # not sqrt(128)
    full = dataclasses.replace(cfg, d_model=4096)
    x = build_model(full)._embed(
        {"embed": torch.ones(2, 4096, dtype=torch.bfloat16)},
        torch.tensor([[0]]))
    assert float(x[0, 0, 0]) == 64.0


def test_params_from_jax_rejects_a_bad_tree():
    jm, jp, tm, _ = both_models("qwen3-8b", "f32")
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="missing leaves.*lm_head"):
        params_from_jax(bad, tm.cfg, tm.opt, "cpu")
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected leaves.*extra"):
        params_from_jax(bad, tm.cfg, tm.opt, "cpu")
    bad = dict(tree, final_norm=np.ones(64, np.float32))
    with pytest.raises(ValueError, match="final_norm.*shape"):
        params_from_jax(bad, tm.cfg, tm.opt, "cpu")
    with pytest.raises(ValueError, match="'layers'"):
        params_from_jax({"embed": tree["embed"]}, tm.cfg, tm.opt, "cpu")


def test_init_is_seeded_by_a_stable_path_hash():
    """Per-leaf seeds come from CRC-32 of the leaf's path: fixed across
    processes (unlike Python's salted str hash), equal for equal seeds,
    different for different paths and seeds; the tree is an nn.Module."""
    assert leaf_seed(0, ("layers", "attn", "wq")) == 1068734748
    assert leaf_seed(5, ("embed",)) == 737679641
    cfg = dataclasses.replace(get_arch("granite-3-2b").reduced(),
                              num_layers=2)
    model = build_model(cfg, ModelOptions(dtype=torch.float32))
    a, b, c = (model.init(s, "cpu") for s in (0, 0, 1))
    assert isinstance(a, ParamTree) and "lm_head" not in a   # tied embeddings
    for (pa, ta), (_, tb), (_, tc) in zip(a.named_parameters(),
                                          b.named_parameters(),
                                          c.named_parameters()):
        assert torch.equal(ta, tb), pa
        assert not ta.requires_grad
        if ta.std() > 0:
            assert not torch.equal(ta, tc), pa
    assert not torch.equal(a["layers"]["attn"]["wq"][0],
                           a["layers"]["attn"]["wq"][1])
    caches = init_from_specs(model.cache_specs(2, 8), 0, "cpu")
    assert caches["k"].shape == (2, 2, 8, cfg.num_kv_heads, 32)


def test_server_refuses_frontend_families_as_jax():
    """The encoder-decoder and VLM families need frames or patches with
    each prompt, which the server's token-only admission does not take:
    the port's BatchServer raises NotImplementedError in both schedulers.
    The reference's run_continuous raises so too; its run_wave fails on
    the missing input with a KeyError (ROADMAP.md Queue 3). Blockwise
    attention, ported since, gives the dense result on the same
    inputs."""
    from repro.runtime.server import BatchServer as JaxServer
    from repro.runtime.server import Request as JaxRequest
    from repro_torch.runtime.server import BatchServer, Request

    for arch in ("whisper-base", "llava-next-34b"):
        jm, jp, tm, tp = both_models(arch, "f32")
        for run in ("run_continuous", "run_wave"):
            server = BatchServer(tm, tp, slots=2, max_len=16)
            server.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
            with pytest.raises(NotImplementedError,
                               match="token-only prefill"):
                getattr(server, run)()
            jserver = JaxServer(jm, jp, slots=2, max_len=16)
            jserver.submit(JaxRequest(prompt=[1, 2, 3], max_new_tokens=2))
            with pytest.raises(NotImplementedError if run == "run_continuous"
                               else KeyError):
                getattr(jserver, run)()
    q = torch.randn(1, 4, 4, 32)
    kv = torch.randn(1, 4, 2, 32)
    pos = torch.arange(4)[None]
    torch.testing.assert_close(
        attn.sdpa(q, kv, kv, pos, pos, impl="blockwise", chunk=2),
        attn.sdpa(q, kv, kv, pos, pos, impl="dense"))


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_recurrent_unrolled_logits_match_jax(arch):
    """The unrolled layout (Mamba-2's other layout; RecurrentGemma's only
    one, its stack is never uniform) against JAX's, prefill then two decode
    steps, float32."""
    jm, jp, tm, tp = both_models(arch, "f32", scan=False)
    assert isinstance(tp["layers"], torch.nn.ModuleList)
    prefill, decode = jitted(jm)
    toks = np.random.default_rng(5).integers(1, tm.cfg.vocab_size, (2, 40))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :38])}, max_len=40)
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :38], jnp.int32)},
                     max_len=40)
    np.testing.assert_allclose(f32(tl), f32(jl), rtol=1e-4, atol=1e-4)
    for n in (38, 39):
        tl, tc = tm.decode_step(tp, _t(toks[:, n:n + 1]), tc, n)
        jl, jc = decode(jp, jnp.asarray(toks[:, n:n + 1], jnp.int32), jc,
                        jnp.asarray(n, jnp.int32))
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plen", [1, 2, 9, 40])
@pytest.mark.parametrize("arch,scan", [("mamba2-780m", True),
                                       ("mamba2-780m", False),
                                       ("recurrentgemma-2b", True)])
def test_recurrent_prefill_then_decode_equals_full_forward(arch, scan, plen):
    """Prefill, then decode three tokens: the last logits equal a full
    forward over all of them. Catches recurrent state that is not written
    into the caches (decode would start from zeros), in the scanned layout
    too (views of the stacked caches), and prompts shorter than the conv's
    k - 1 inputs (1 and 2 tokens; the JAX package fails on those,
    ROADMAP.md Queue 3). 40 tokens overflow RecurrentGemma's 32-slot local
    ring and span two of Mamba-2's 32-token chunks."""
    from repro_torch.runtime.server import _mark_prefill_tail

    cfg = get_arch(arch).reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32,
                                          scan_layers=scan))
    params = model.init(0, "cpu")
    toks = _t(np.random.default_rng(plen).integers(1, cfg.vocab_size,
                                                   (2, plen + 3)))
    full, _ = model.prefill(params, {"tokens": toks})
    logits, caches = model.prefill(params, {"tokens": toks[:, :plen]},
                                   max_len=plen + 3)
    caches = _mark_prefill_tail(caches, plen)
    for n in range(plen, plen + 3):
        logits, caches = model.decode_step(params, toks[:, n:n + 1], caches,
                                           n)
    np.testing.assert_allclose(f32(logits), f32(full), rtol=1e-4, atol=1e-4)


def test_recurrent_cache_specs():
    """Per-kind decode caches: RecurrentGemma's pattern (rglru, rglru,
    attn) with a local ring of min(max_len, local_window) slots; Mamba-2's
    stacked SSD state and conv inputs."""
    cfg = get_arch("recurrentgemma-2b").reduced()      # window 32, width 128
    caches = init_from_specs(build_model(cfg).cache_specs(3, 40), 0, "cpu")
    assert [sorted(c) for c in caches] == [["conv", "h"], ["conv", "h"],
                                           ["k", "pos", "v"], ["conv", "h"]]
    assert caches[0]["h"].shape == (3, 128)
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].shape == (3, 3, 128)
    assert caches[2]["k"].shape == (3, 32, 1, 32)      # MQA ring of 32
    cfg = get_arch("mamba2-780m").reduced()
    caches = init_from_specs(build_model(cfg).cache_specs(3, 40), 0, "cpu")
    assert caches["state"].shape == (4, 3, 16, 16, 16)  # (L, b, h, p, n)
    assert caches["conv_x"].shape == (4, 3, 3, 256)
    assert caches["conv_B"].shape == caches["conv_C"].shape == (4, 3, 3, 16)
