"""The port's logical-axis sharding rules (``repro_torch.sharding.rules``),
parameter axes and elastic block cuts against the JAX package's.

Every leaf of every architecture, scanned and unrolled, carries the JAX
model's logical axes; ``resolve_pspec`` (and ``explain_pspec``) give the
JAX package's specs for each of them under the train and decode rules on
fake (16, 16), (2, 16, 16), (1, 4), (2, 2) and (4, 1) meshes, built as
``tests/test_sharding_rules.py`` builds its context (no devices, no
ranks). That file's cases are ported, the hypothesis invariant with a
fixed sweep beside it. The blocks ``checkpoint.elastic`` cuts tile each
leaf exactly once per replica, numbered row-major over a dim's axes.
"""
from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import PartitionSpec as JP

from repro.config.registry import get_arch as jax_arch
from repro.config.registry import list_archs
from repro.models.layers import ParamSpec as JaxSpec
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.sharding import rules as jrules
from repro_torch.checkpoint.elastic import (block_index, reshard,
                                            shardings_for, unshard)
from repro_torch.config.registry import get_arch
from repro_torch.launch.mesh import ProcessMesh, make_mesh
from repro_torch.models.layers import ParamSpec, leaf_paths
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (P, ShardingContext, current_context,
                                        explain_pspec, no_sharding,
                                        resolve_pspec, rules_for,
                                        use_sharding)

ARCHS = list_archs()
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 4): ("data", "model"), (2, 2): ("data", "model"),
          (4, 1): ("data", "model")}


def _fake(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape, object)

    return FakeMesh()


@pytest.fixture(scope="module")
def ctx256():
    """Resolver-only context with a fake 16x16 mesh (no devices needed)."""
    return ShardingContext(_fake((16, 16), ("data", "model")))


# ------------------------------------------- tests/test_sharding_rules.py
def test_divisible_dims_shard(ctx256):
    # llama3 wq: (d_model, heads, head_dim) = (16384, 128, 128)
    spec = resolve_pspec((16384, 128, 128), ("embed", "heads", "head_dim"),
                         ctx256)
    assert spec == P("data", "model") == JP("data", "model")


def test_indivisible_heads_fall_back(ctx256):
    # llava: 56 heads % 16 != 0 -> replicate that dim, keep the others
    spec = resolve_pspec((7168, 56, 128), ("embed", "heads", "head_dim"),
                         ctx256)
    assert spec == P("data")


def test_vocab_fallback_granite(ctx256):
    # granite vocab 49155 is odd -> embedding replicates on vocab, shards d
    spec = resolve_pspec((49155, 2048), ("vocab", "embed"), ctx256)
    assert spec == P(None, "data")


def test_no_axis_reuse_within_tensor(ctx256):
    # both logical axes want 'model'; second must fall through
    spec = resolve_pspec((64, 64), ("seq", "vocab"), ctx256)
    flat = [a for e in spec if e for a in
            (e if isinstance(e, tuple) else (e,))]
    assert len(flat) == len(set(flat))
    assert spec[0] == "model"


def _invariants(ctx, dim0, dim1):
    """For any shape: placed axes divide their dims and are never reused;
    the spec is the JAX package's."""
    spec = resolve_pspec((dim0, dim1), ("mlp", "heads"), ctx)
    used = []
    for size, entry in zip((dim0, dim1), list(spec) + [None] * 2):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for a in axes:
            prod *= ctx.axis_size(a)
            used.append(a)
        assert size % prod == 0
    assert len(used) == len(set(used))
    assert spec == jrules.resolve_pspec(
        (dim0, dim1), ("mlp", "heads"), jrules.ShardingContext(ctx.mesh))


@given(dim0=st.integers(1, 4096), dim1=st.integers(1, 4096))
@settings(max_examples=200, deadline=None)
def test_resolver_invariants(ctx256, dim0, dim1):
    _invariants(ctx256, dim0, dim1)


def test_resolver_invariants_on_a_sweep(ctx256):
    """The property above on a fixed sweep (every dim up to 64, and the
    multiples and near-multiples of 16 up to 4096), so it runs where
    hypothesis is not installed."""
    dims = sorted(set(range(1, 65)) | {k * 16 + e for k in range(1, 257)
                                        for e in (-1, 0, 1)})
    for dim0, dim1 in itertools.product(dims[::7], dims[::5]):
        _invariants(ctx256, dim0, dim1)


def test_identity_outside_context():
    """No installed context places nothing; use_sharding installs one and
    restores the previous on exit, no_sharding clears it for its body."""
    assert current_context() is None
    assert resolve_pspec((4, 4), ("batch", "seq")) == P()
    mesh = _fake((2, 2), ("data", "model"))
    with use_sharding(mesh) as ctx:
        assert current_context() is ctx
        assert resolve_pspec((4, 4), ("batch", "seq")) == P("data", "model")
        with no_sharding():
            assert resolve_pspec((4, 4), ("batch", "seq")) == P()
        assert current_context() is ctx
    assert current_context() is None


def test_multi_pod_axes_collapse(ctx256):
    """('pod','data') candidates collapse to the axes present in the mesh."""
    spec = resolve_pspec((256, 64), ("batch", None), ctx256)
    assert spec == P("data")  # no 'pod' axis in a single-pod mesh


# ------------------------------------------------ tables and every arch
def test_rule_tables_are_the_jax_packages():
    for name in ("DEFAULT_RULES", "SERVE_RULES", "TRAIN_DP_RULES"):
        assert getattr(rules, name) == getattr(jrules, name), name
    for kind in ("train", "prefill", "decode"):
        assert rules_for(kind) == jrules.rules_for(kind)


def _jax_specs(arch, scan):
    jm = jax_build(jax_arch(arch), JaxOptions(scan_layers=scan))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jm.param_specs(), is_leaf=lambda s: isinstance(s, JaxSpec))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): s
            for p, s in flat}


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_jax_models(arch, scan):
    """param_axes() carries the JAX model's logical axes leaf for leaf (a
    scanned stack's lead with "layers"), at the published widths."""
    want = _jax_specs(arch, scan)
    model = build_model(get_arch(arch), ModelOptions(scan_layers=scan))
    specs = leaf_paths(model.param_specs())
    assert set(specs) == set(want)
    axes = model.param_axes()
    for path, spec in specs.items():
        assert spec.axes == tuple(want[path].axes), path
        assert spec.shape == tuple(want[path].shape), path
        node = axes
        for k in path:
            node = node[k]
        assert node == spec.axes


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_pspec_equals_the_jax_packages(arch, kind):
    """Every leaf of every arch, scanned and unrolled, on every fake mesh:
    the port's spec and explanation are the JAX package's."""
    for scan in (True, False):
        want = _jax_specs(arch, scan)
        specs = leaf_paths(build_model(
            get_arch(arch), ModelOptions(scan_layers=scan)).param_specs())
        for shape, axes in MESHES.items():
            mesh = _fake(shape, axes)
            ctx = ShardingContext(mesh, rules_for(kind))
            jctx = jrules.ShardingContext(mesh, jrules.rules_for(kind))
            for path, spec in specs.items():
                got = resolve_pspec(spec.shape, spec.axes, ctx)
                assert got == jrules.resolve_pspec(spec.shape, spec.axes,
                                                   jctx), (path, shape)
                assert explain_pspec(spec.shape, spec.axes, ctx) == \
                    jrules.explain_pspec(spec.shape, spec.axes, jctx)


def test_param_spec_checks_its_axes():
    with pytest.raises(ValueError, match="disagree"):
        ParamSpec((4, 4), ("embed",))
    with pytest.raises(ValueError, match="disagree"):
        resolve_pspec((4, 4), ("embed",),
                      ShardingContext(_fake((2, 2), ("data", "model"))))


# ------------------------------------------------------- elastic blocks
def _meshes(shape, axes):
    return [ProcessMesh(axes, shape, r, torch.device("cpu"))
            for r in range(int(np.prod(shape)))]


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
    ((2, 1, 2), ("pod", "data", "model")), ((2, 2, 2), ("pod", "data", "model"))])
def test_blocks_tile_every_leaf_once_per_replica(shape, axes):
    """Under the train rules, the blocks the ranks of a mesh hold cover
    each leaf of reduced qwen3-8b and granite-3-2b exactly as many times as
    the spec leaves it replicated; a dim on ("pod", "data") numbers its
    blocks pod-major (GSPMD's row-major order over the spec's axes)."""
    meshes = _meshes(shape, axes)
    for arch in ("qwen3-8b", "granite-3-2b"):
        model = build_model(get_arch(arch).reduced(),
                            ModelOptions(scan_layers=False))
        ctx = ShardingContext(meshes[0], rules_for("train"))
        for spec in leaf_paths(model.param_specs()).values():
            pspec = resolve_pspec(spec.shape, spec.axes, ctx)
            placed = [a for e in pspec for a in rules.entry_axes(e)]
            copies = len(meshes) // int(np.prod(
                [dict(zip(axes, shape))[a] for a in placed] or [1]))
            count = np.zeros(spec.shape, int)
            for m in meshes:
                count[block_index(spec.shape, pspec, m)] += 1
            assert (count == copies).all(), (arch, spec, pspec)
    if "pod" not in axes:
        return
    spec = P(("pod", "data"))
    for m in meshes:
        pod, data = m.coords[0], m.coords[1]
        n = shape[1]
        size = 8 // (shape[0] * n)
        assert block_index((8,), spec, m)[0].start == (pod * n + data) * size


def test_reshard_and_unshard_on_one_rank():
    """On a one-rank mesh every block is the whole leaf: reshard copies,
    unshard gives it back, and shardings_for takes a spec tree or a tensor
    tree with the logical-axes tree."""
    model = build_model(get_arch("qwen3-8b").reduced(),
                        ModelOptions(dtype=torch.float32))
    params = model.init(0, "cpu")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    axes = model.param_axes()
    blocks = reshard(params, axes, mesh)
    sh = shardings_for(model.param_specs(), axes, mesh)
    back = unshard(blocks, sh, mesh)
    for a, b, c in zip(leaf_paths(params).values(),
                       leaf_paths(blocks).values(),
                       leaf_paths(back).values()):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert b.data_ptr() != a.data_ptr()


@pytest.mark.parametrize("shape,axes,placed", [
    ((2, 2), ("data", "model"), ("data", "model")),
    ((2, 2), ("data", "model"), ("model", "data")),      # SERVE_RULES' order
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
    ((2, 3, 2), ("pod", "data", "model"), ("model", "pod"))])
def test_gather_order_matches_the_blocks_ranks_hold(shape, axes, placed):
    """The block a gather puts at group rank g (``tp.block_order``: the
    group's ranks sorted, numbered row-major over the spec's axes) is the
    block that rank holds (``elastic.block_index``), whatever the order of
    the axes in the spec."""
    from repro_torch.sharding.tp import block_order

    meshes = _meshes(shape, axes)
    sizes = dict(zip(axes, shape))
    n = int(np.prod([sizes[a] for a in placed]))
    ks = [axes.index(a) for a in placed]
    for m in meshes:
        # the ranks of m's group over `placed`, sorted (dist.new_group's)
        group = sorted(o.rank for o in meshes if all(
            o.coords[k] == m.coords[k] for k in range(len(axes))
            if k not in ks))
        order = block_order(m, placed)
        for g, r in enumerate(group):
            blk = block_index((4 * n,), P(placed), meshes[r])[0]
            assert blk.start == order[g] * 4, (placed, g, r)
