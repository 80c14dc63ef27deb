"""The port's training pieces on the CPU against the JAX package: the fused
linear cross-entropy, ``train_loss`` and its gradients (reduced
internlm2-1.8b, granite-3-2b with tied embeddings, qwen3-8b with qk-norm,
qwen3-moe-30b-a3b with its aux loss; scanned and unrolled; remat "none"
and "full"), layer provenance, AdamW,
the learning-rate schedule and the synthetic data pipeline. Parameters are
one numpy-drawn tree loaded into both packages (``_torch_jax.py``).

Tolerances: float32 rtol 1e-4 (relative to each leaf's largest entry: the
frameworks order float32 sums differently); the fused xent at the JAX
suite's own (``tests/test_xent.py``); AdamW and the schedule rtol 1e-5,
atol 1e-6. In bf16 the two frameworks round at other places: the loss
agrees at the JAX suite's bf16 rtol 2e-2, and each gradient leaf within 5%
of its largest entry (the JAX suite's bound for the fused xent's bf16
gradients), or within twice JAX's own bf16 error (its bf16 gradient against
its float32 one on the same bf16-rounded parameters) where that is more:
the scanned reduced configs draw their stacked weights with fan_in = the
layer count (as the JAX package's init does, ``ROADMAP.md`` Queue 3), and
their large activations amplify every rounding.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_jax import both_models, f32

from repro.data.pipeline import SyntheticLMDataset as JaxData
from repro.models import xent as jxent
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.optim.schedule import warmup_cosine as jwarmup
from repro_torch.core.overlap import value_and_grad
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import xent
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

BF16_ULP = 2.0 ** -8


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ------------------------------------------------------------- linear_xent
def _xent_inputs(b=2, s=16, d=32, v=64):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    return x, w, rng.integers(0, v, (b, s))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_xent_matches_jax(dtype):
    """Loss and (dx, dw) against the JAX package's custom VJP: float32 at
    its suite's rtol 1e-5 (loss) and rtol 2e-3, atol 2e-5 (grads), bf16 at
    its 2e-2 (loss) and 5% of the largest entry (grads); and against the
    port's own naive oracle, as the JAX suite holds its op."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, w, t = _xent_inputs()
    jx, jw, jt = jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(t)
    tx = _t(x, tdt).requires_grad_(True)
    tw = _t(w, tdt).requires_grad_(True)
    tt = torch.from_numpy(t)
    loss = xent.linear_xent(tx, tw, tt)
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    loss = loss.detach()
    jloss, (jdx, jdw) = jax.value_and_grad(jxent.linear_xent, (0, 1))(
        jx, jw, jt)
    assert loss.dtype == torch.float32
    ref_loss = xent.xent_ref(tx, tw, tt)
    rdx, rdw = torch.autograd.grad(ref_loss, (tx, tw))
    ref_loss = ref_loss.detach()
    if dtype == "f32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for got, want in ((dx, jdx), (dw, jdw), (dx, rdx), (dw, rdw)):
            np.testing.assert_allclose(f32(got), f32(want), rtol=2e-3,
                                       atol=2e-5)
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
        for got, want in ((dx, jdx), (dw, jdw), (dx, rdx), (dw, rdw)):
            assert got.dtype == torch.bfloat16
            err = np.abs(f32(got) - f32(want)).max()
            assert err / max(np.abs(f32(want)).max(), 1e-6) < 0.05, err


def test_linear_xent_saves_no_logits():
    """The backward keeps (x, w, targets, lse), not the (b, s, V) logits."""
    x, w, t = _xent_inputs()
    tx = _t(x).requires_grad_(True)
    loss = xent.linear_xent(tx, _t(w), torch.from_numpy(t))
    saved = loss.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [(2, 16, 32), (32, 64),
                                               (2, 16), (2, 16)]


# ------------------------------------------------------ train_loss and grads
def _batch(vocab, b=2, s=16, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


def _jax_value_and_grad(jm, jp, jb):
    loss, g = jax.jit(jax.value_and_grad(jm.train_loss))(jp, jb)
    return float(loss), [f32(a) for a in jax.tree.leaves(g)]


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, scan, dtype):
    """JAX's loss and gradients of the reduced `arch` (the same numpy draw
    as ``both_models``'s). One per layout and dtype: remat recomputes and
    changes no value (the port's "full" is held bit-equal to its "none" by
    test_remat_full_recomputes_in_the_backward)."""
    jm, jp, tm, _ = both_models(arch, dtype, attn_impl="dense", scan=scan)
    jb, _ = _batch(tm.cfg.vocab_size)
    return _jax_value_and_grad(jm, jp, jb)


@functools.lru_cache(maxsize=None)
def _jax_f32_reference(arch, scan):
    """JAX's float32 loss and gradients on the bf16-rounded parameters of
    the reduced `arch` (the same numpy draw as ``both_models``'s)."""
    jm, jp, tm, _ = both_models(arch, "bf16", attn_impl="dense", scan=scan)
    j32 = jax_build(jm.cfg, dataclasses.replace(jm.opt, dtype=jnp.float32))
    jb, _ = _batch(tm.cfg.vocab_size)
    return _jax_value_and_grad(
        j32, jax.tree.map(lambda a: a.astype(jnp.float32), jp), jb)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-3-2b",
                                  "qwen3-8b"])
def test_train_loss_and_grads_match_jax(arch, scan, remat, dtype):
    _, _, tm, tp = both_models(arch, dtype, attn_impl="dense", scan=scan)
    tm.opt = dataclasses.replace(tm.opt, remat=remat)
    _, tb = _batch(tm.cfg.vocab_size)
    tp.requires_grad_(True)
    loss, grads = value_and_grad(tm.train_loss)(tp, tb)
    got = [f32(g) for g in tree_leaves(grads)]
    assert [tuple(g.shape) for g in got] == [
        tuple(p.shape) for p in tree_leaves(tp)]
    want_loss, want = _jax_reference(arch, scan, dtype)
    if dtype == "f32":
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())
        return
    # bf16: JAX's own bf16 error, against its float32 on the same
    # bf16-rounded parameters
    _, ref = _jax_f32_reference(arch, scan)
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-2)
    for (path, g), p, w, r in zip(leaf_paths(grads).items(),
                                  tree_leaves(tp), want, ref):
        assert g.dtype == p.dtype
        bound = max(0.05 * np.abs(w).max(), 2 * np.abs(w - r).max())
        assert np.abs(f32(g) - w).max() <= bound, path


@pytest.mark.parametrize("fused,remat,scan", [(True, "none", True),
                                               (True, "full", False),
                                               (False, "none", False)])
def test_moe_train_loss_and_grads_match_jax(fused, remat, scan):
    """Reduced Qwen3-MoE (4 experts, top-2, capacity factor 1.25, so
    experts drop tokens), float32: train_loss is the cross-entropy plus the
    layers' summed aux load-balancing loss, fused or not, under remat
    "full" too (the checkpointed layer returns its aux); loss and
    gradients against JAX's at rtol 1e-4, the aux within 1e-6."""
    jm, jp, tm, tp = both_models("qwen3-moe-30b-a3b", "f32",
                                 attn_impl="dense", scan=scan)
    jm = jax_build(jm.cfg, dataclasses.replace(jm.opt, fused_xent=fused))
    tm.opt = dataclasses.replace(tm.opt, fused_xent=fused, remat=remat)
    jb, tb = _batch(tm.cfg.vocab_size)
    tp.requires_grad_(True)
    loss, grads = value_and_grad(tm.train_loss)(tp, tb)
    want_loss, want = _jax_value_and_grad(jm, jp, jb)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for g, w in zip(tree_leaves(grads), want):
        np.testing.assert_allclose(f32(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    with torch.no_grad():
        _, _, aux = tm._forward(tp, tb, "train")
    jaux = jax.jit(lambda p, b: jm._forward(p, b, "train")[2])(jp, jb)
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-3-2b"])
def test_unfused_train_loss_matches_jax(arch):
    """fused_xent=False: the float32 logits' log-softmax, in both."""
    jm, jp, tm, tp = both_models(arch, "f32", attn_impl="dense", scan=False)
    jm = jax_build(jm.cfg, dataclasses.replace(jm.opt, fused_xent=False))
    tm.opt = dataclasses.replace(tm.opt, fused_xent=False)
    jb, tb = _batch(tm.cfg.vocab_size)
    tp.requires_grad_(True)
    loss, grads = value_and_grad(tm.train_loss)(tp, tb)
    want_loss, want = _jax_value_and_grad(jm, jp, jb)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for g, w in zip(tree_leaves(grads), want):
        np.testing.assert_allclose(f32(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-3-2b",
                                  "qwen3-8b", "qwen3-moe-30b-a3b"])
def test_param_layers_match_jax(arch, scan):
    """Layer provenance leaf for leaf: embed 0, the stack 1..N (a scanned
    stack is one depth), final_norm and lm_head at N + 1."""
    jm, _, tm, _ = both_models(arch, "f32", attn_impl="dense", scan=scan)
    got = leaf_paths(tm.param_layers())
    want = jax.tree_util.tree_flatten_with_path(jm.param_layers())[0]
    assert len(got) == len(want)
    for (path, depth), (jpath, jdepth) in zip(got.items(), want):
        assert [str(p) for p in path] == [
            str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath]
        assert depth == jdepth
    n = tm.cfg.num_layers
    assert got[("embed",)] == 0 and got[("final_norm",)] == n + 1
    assert set(got.values()) == ({0, 1, n + 1} if scan
                                 else set(range(n + 2)))


def test_scanned_init_follows_the_reference_fan_in():
    """Both packages' init takes fan_in = shape[0], which for a scanned
    stack's leaf is the layer count (ROADMAP.md Queue 3): the port keeps
    the reference's draw, so a scanned stack's weights are wider than an
    unrolled one's by sqrt(d_model / num_layers)."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model

    cfg = get_arch("internlm2-1.8b").reduced()
    for scan, fan_in in ((True, cfg.num_layers), (False, cfg.d_model)):
        p = build_model(cfg, ModelOptions(scan_layers=scan)).init(0, "cpu")
        wq = p["layers"]["attn"]["wq"] if scan else p["layers"][0]["attn"]["wq"]
        assert abs(float(wq.float().std()) * fan_in ** 0.5 - 1) < 0.05


def test_remat_full_recomputes_in_the_backward():
    """remat="full" keeps fewer saved tensors than "none" on the same
    graph, with the same gradients bit for bit."""
    _, _, tm, tp = both_models("internlm2-1.8b", "f32", attn_impl="dense",
                               scan=False)
    _, tb = _batch(tm.cfg.vocab_size)
    tp.requires_grad_(True)
    out = {}
    for remat in ("none", "full"):
        tm.opt = dataclasses.replace(tm.opt, remat=remat)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            loss = tm.train_loss(tp, tb)
        g = torch.autograd.grad(loss, tree_leaves(tp))
        out[remat] = (sum(saved), g)
    assert out["full"][0] < out["none"][0] / 2
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- AdamW
def _adamw_tree(rng):
    def draw(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return {"a": draw(4, 8), "b": draw(16), "c": {"d": draw(3, 5, 2)},
            "e": draw(3, 6)}


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adamw_matches_jax(moment_dtype):
    """Three updates of a mixed tree (a bf16 leaf "e"), clipped (global
    norm above grad_clip) and not, against the JAX package's: float32
    leaves, moments and the grad norm at rtol 1e-5, atol 1e-6; the bf16
    leaf and bf16 moments within one bf16 ulp (a float32 difference in the
    last place may round the other way)."""
    jmd, tmd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[moment_dtype]
    rng = np.random.default_rng(7)
    params = _adamw_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jp["e"] = jp["e"].astype(jnp.bfloat16)
    tp = {"a": _t(params["a"]), "b": _t(params["b"]),
          "c": {"d": _t(params["c"]["d"])}, "e": _t(params["e"],
                                                     torch.bfloat16)}
    cfg = AdamWConfig(lr=1e-2, grad_clip=0.5)
    jcfg = jadamw.AdamWConfig(lr=1e-2, grad_clip=0.5)
    jstate, tstate = jadamw.adamw_init(jp, jmd), adamw_init(tp, tmd)
    for k, scale in enumerate((0.01, 1.0, 0.02)):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                    ).astype(np.float32), params)
        jg = jax.tree.map(jnp.asarray, g)
        jg["e"] = jg["e"].astype(jnp.bfloat16)
        tg = {"a": _t(g["a"]), "b": _t(g["b"]), "c": {"d": _t(g["c"]["d"])},
              "e": _t(g["e"], torch.bfloat16)}
        lr = warmup_cosine(tstate["step"], cfg.lr, 1, 10)
        jlr = jwarmup(jstate["step"], jcfg.lr, 1, 10)
        tp, tstate, tnorm = adamw_update(tg, tstate, tp, cfg, lr)
        jp, jstate, jnorm = jadamw.adamw_update(jg, jstate, jp, jcfg, jlr)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
        assert int(tstate["step"]) == int(jstate["step"]) == k + 1
        for got, want in [(tp, jp), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])]:
            for (path, a), b in zip(leaf_paths(got).items(),
                                    jax.tree.leaves(want)):
                a, b = f32(a), f32(b)
                if path == ("e",) or moment_dtype == "bf16" and got is not tp:
                    assert (np.abs(a - b) <= BF16_ULP * np.abs(b)
                            + 1e-30).all(), path
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert tstate["m"]["e"].dtype == tmd and tp["e"].dtype == torch.bfloat16


def test_adamw_chunked_equals_plain():
    """chunk_leading updates a stacked leaf slice by slice, bit for bit."""
    rng = np.random.default_rng(1)
    p0 = (rng.standard_normal((4, 6, 5)) * 0.1).astype(np.float32)
    g = (rng.standard_normal((4, 6, 5)) * 0.1).astype(np.float32)
    out = []
    for chunk in (0, 4):
        p = {"w": _t(p0)}
        state = adamw_init(p)
        adamw_update({"w": _t(g)}, state, p, AdamWConfig(), torch.tensor(1e-3),
                     chunk_leading=chunk)
        out.append((p["w"], state["m"]["w"], state["v"]["w"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_warmup_cosine_matches_jax():
    for step in range(0, 13):
        for warmup, total in ((3, 10), (0, 5), (1, 1)):
            np.testing.assert_allclose(
                float(warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                    3e-4, warmup, total)),
                float(jwarmup(jnp.asarray(step, jnp.int32), 3e-4, warmup,
                              total)), rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("a", [1, 31])
def test_data_pipeline_bit_equal(a):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=5, a=a)
    got, want = SyntheticLMDataset(**kw), JaxData(**kw)
    for step in (0, 1, 7):
        for k, v in want.batch_at(step).items():
            np.testing.assert_array_equal(got.batch_at(step)[k], v)
            assert got.batch_at(step)[k].dtype == v.dtype
        for hosts in (1, 2, 4, 8):
            for h in range(hosts):
                for k, v in want.host_slice(step, h, hosts).items():
                    np.testing.assert_array_equal(
                        got.host_slice(step, h, hosts)[k], v)
    assert got.state(3) == want.state(3)
    assert SyntheticLMDataset.resume_step(got.state(3)) == 3
