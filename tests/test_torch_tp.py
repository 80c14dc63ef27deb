"""The port's TP rings (``core/collective_matmul.py``) and TP decode step
(``models/decode_tp.py``) on one process, against the JAX package: the ring
arithmetic (pieces, sends a ring and a decode step) equal to the JAX
package's for every size tried, ``build_decode_step``'s checks raising the
JAX package's errors for the same meshes, and the one-rank step (no ring:
fused slices, per-row cache writes) equal to ``model.decode_step`` on
reduced Qwen3-8B in float32 (rtol 1e-5), through the server too. The rings
on several ranks are in ``tests/test_torch_dist.py``.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import TP_MAX_NEW, TP_PROMPTS, tp_admitted, tp_model, tp_serve

from repro.config.registry import get_arch as jax_arch
from repro.core import collective_matmul as jcm
from repro.models.decode_tp import build_decode_step as jax_build_step
from repro.models.decode_tp import expected_permute_total as jax_expected
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro_torch.config.registry import get_arch
from repro_torch.core import collective_matmul as cm
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.decode_tp import build_decode_step, expected_permute_total
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.runtime.server import BatchServer, Request, _walk

SIZES = (0, 1, 2, 3, 4, 5, 7, 11, 13, 15, 16, 31)
CHUNKS = (None, 1, 2, 3, 4, 7, 64)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_ring_arithmetic_equals_jax(n):
    assert cm._ring_perms(n) == jcm._ring_perms(n)
    for s_loc in SIZES:
        for bidirectional in (True, False):
            for chunks in CHUNKS:
                assert (cm._ring_pieces(s_loc, bidirectional, chunks)
                        == jcm._ring_pieces(s_loc, bidirectional, chunks))
                assert (cm.ring_permute_count(s_loc, n, bidirectional,
                                              chunks)
                        == jcm.ring_permute_count(s_loc, n, bidirectional,
                                                  chunks))


@pytest.mark.parametrize("reduced", [True, False])
def test_expected_permute_total_equals_jax(reduced):
    cfg, jcfg = get_arch("qwen3-8b"), jax_arch("qwen3-8b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for slots in (4, 8, 12, 16, 60):
        for dp in (1, 2):
            for tp in (1, 2, 3, 4):
                for chunks in CHUNKS:
                    assert (expected_permute_total(cfg, slots, dp, tp, chunks)
                            == jax_expected(jcfg, slots, dp, tp, chunks))
    # Qwen3-8B at full width over 4 cards, 8 slots: 145 rings of 2 pieces
    assert expected_permute_total(get_arch("qwen3-8b"), 8, 1, 4) == 870


class _StubMesh:
    """build_decode_step validates divisibility from mesh.shape alone, before
    any rank is touched (tests/test_decode_tp.py's stub)."""

    def __init__(self, dp: int, tp: int):
        self.shape = {"data": dp, "model": tp}


def _models(arch="qwen3-8b", **replace):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), **replace)
    return (build_model(cfg, ModelOptions()),
            jax_build(jcfg, JaxOptions(attn_impl="dense")))


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case,arch,replace,mesh", [
    ("dense family", "qwen3-moe-30b-a3b", {}, (1, 2)),
    ("heads", "qwen3-8b", {}, (1, 3)),            # 4 q / 2 kv vs tp=3
    ("d_ff", "qwen3-8b", {"d_ff": 129}, (1, 2)),
])
def test_build_checks_raise_the_jax_errors(case, arch, replace, mesh):
    tm, jm = _models(arch, **replace)
    want = _error(lambda: jax_build_step(jm, _StubMesh(*mesh)))
    got = _error(lambda: build_decode_step(tm, _StubMesh(*mesh)))
    assert case in got and got == want


def test_step_rejects_slots_that_do_not_divide():
    tm, jm = _models()
    token = np.zeros((6, 1), np.int32)
    want = _error(lambda: jax_build_step(jm, _StubMesh(2, 2))(
        None, jnp.asarray(token), None, None))
    got = _error(lambda: build_decode_step(tm, _StubMesh(2, 2))(
        None, torch.from_numpy(token).long(), None, None))
    assert "slots (6)" in got and got == want


def test_unknown_mode_raises():
    """The JAX package runs an unknown mode as two_phase; the port raises,
    as it does for the solvers' modes."""
    tm, _ = _models()
    with pytest.raises(ValueError, match="mode 'eager'"):
        build_decode_step(tm, _StubMesh(1, 1), mode="eager")
    with pytest.raises(ValueError, match="mode 'eager'"):
        cm.ag_matmul(torch.ones(2, 2), torch.ones(2, 2), None, "model",
                     "eager")


SPEC = dict(layers=2, heads=[4, 2], seed=0, slots=4, max_len=16)


def _clone(caches):
    return _walk(caches, lambda _, t: t.clone())


@pytest.mark.parametrize("mode", ["hdot", "two_phase"])
@pytest.mark.parametrize("scan", [True, False])
def test_one_rank_step_equals_decode_step(scan, mode):
    """No ring on one rank: the fused slices, per-row ring writes and
    dense attention on the rank's view give model.decode_step's logits and
    caches (rtol 1e-5); the tree is cut anew once it is updated in place,
    and so is a second tree passed to the same step."""
    model, params = tp_model(SPEC, "cpu")
    if not scan:
        model = build_model(model.cfg, dataclasses.replace(model.opt,
                                                           scan_layers=False))
        params = model.init(SPEC["seed"], "cpu")
    step = build_decode_step(model, make_mesh((1, 1), ("data", "model"),
                                              "cpu"), mode=mode)
    def restored(p):
        """`p` itself, restored in place from the tree of another seed."""
        for dst, src in zip(tree_leaves(p),
                            tree_leaves(model.init(SPEC["seed"] + 2, "cpu"))):
            dst.copy_(src)
        return p

    trees = (lambda: params, lambda: restored(params),
             lambda: model.init(SPEC["seed"] + 1, "cpu"))
    for tree in trees:
        p = tree()
        token, caches, pos = tp_admitted(model, p, SPEC, "cpu")
        want_caches = _clone(caches)
        want, _ = model.decode_step(p, token, want_caches, pos)
        got, got_caches = step(p, token, caches, pos)
        assert got.shape == want.shape == (SPEC["slots"], 1,
                                           model.cfg.vocab_size)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        flat = []
        _walk(got_caches, lambda _, t: flat.append(t))
        _walk(want_caches, lambda _, t: flat.append(t))
        half = len(flat) // 2
        for a, b in zip(flat[:half], flat[half:]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_one_rank_server_serves_the_same_tokens():
    model, params = tp_model(SPEC, "cpu")
    step = build_decode_step(model, make_mesh((1, 1), ("data", "model"),
                                              "cpu"))
    want, wstats = tp_serve(model, params, SPEC)
    got, stats = tp_serve(model, params, SPEC, step)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats and stats["admitted"] == len(TP_PROMPTS)
    assert [int((row >= 0).sum()) for row in got] == TP_MAX_NEW


def test_a_failing_decode_step_fn_raises():
    """No fallback to model.decode_step."""
    model, params = tp_model(SPEC, "cpu")

    def broken(*args):
        raise RuntimeError("ring failed")

    srv = BatchServer(model, params, slots=2, max_len=16,
                      decode_step_fn=broken)
    srv.submit(Request(prompt=[1, 2, 3], max_new_tokens=3))
    with pytest.raises(RuntimeError, match="ring failed"):
        srv.run_continuous()
