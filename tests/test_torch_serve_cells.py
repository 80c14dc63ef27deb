"""The serving cells of the port (``launch/steps.py`` ``build_cell``,
``cell_step``) against the JAX package.

(a) For every arch and every runnable shape of ``SHAPES``, the port's
cell has the reference's arg shapes, dtypes (the port's integers are
int64 where the reference's are int32: tokens, targets and the rings'
positions), logical axes and donation, and its resolved specs equal the
reference's ``resolve_pspec`` on fake (2, 2), (1, 4) and (2, 1, 2)
meshes.

(b) The prefill then decode cells of every family (dense, moe, ssm,
hybrid, encdec, vlm) on gloo (1, 4) and (2, 2) ("data", "model") meshes,
and of the dense family (Qwen3 and the tied Granite) on (2, 1, 2)
("pod", "data", "model"): reduced configs, float32, unrolled parameters
drawn with numpy and loaded through ``params_from_jax``. 2 prompts of 12
tokens (28 rows for the VLM, 16 patches first) into 16-slot rings (32 for
the VLM), then 8 teacher-forced decode steps at a scalar position, past
the ring's wrap. On every rank: the gathered logits equal JAX
``model.prefill`` / ``decode_step`` on one device at rtol 1e-4; each
parameter and cache leaf it holds has its block's shape (the parameters
equal to the whole tree's slices), and its bytes are its blocks' bytes;
at (1, 4) the prefill and decode cells' blocks coincide, for the
parameters and the caches. The MoE config's capacity factor is 4, so
that expert parallelism's per-rank capacity drops nothing (at the
reference's 1.25 it would drop, and differ from one device by design).

(c) The sharded flash-decode alone on 4 gloo ranks against the
reference's ``_flash_decode_sharded`` on 4 forced host devices (a
subprocess, as ``tests/test_flash_decode.py`` runs it), within that
test's 2e-4, at windows None and 32; some steps leave a rank with no
visible slot (its block empty, or past the window), and the port's
flash-decode equals its ``_decode_dense`` over the gathered ring.

Each spawn (``tests/_torch_dist.py``) has one deadline.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist import spawn
from _torch_jax import numpy_params
from _torch_serve import (FD, S, T, case_cfg, case_inputs, case_lengths,
                          flash_decode_cfg, flash_decode_inputs)

from repro.config.registry import get_arch as jax_arch
from repro.config.shapes import SHAPES as JAX_SHAPES
from repro.launch.steps import build_cell as jax_build_cell
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.sharding.rules import resolve_pspec as jax_resolve
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.config.shapes import SHAPES, cell_is_runnable
from repro_torch.launch.steps import build_cell
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import leaf_paths, tree_leaves
from repro_torch.models.model import ModelOptions

REPO = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 180

# ------------------------------------------------------------ (a) the specs
FAKE_MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
               ((2, 1, 2), ("pod", "data", "model"))]
CELLS = [(a, name) for a in list_archs() for name, sh in SHAPES.items()
         if cell_is_runnable(get_arch(a).subquadratic, sh)]


def _fake(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape, object)

    return FakeMesh()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flat(spec_tree, other, jax_tree: bool):
    """`other`'s entries at every leaf path of `spec_tree` (a tuple of
    axes or a spec is one entry), in tree order."""
    if jax_tree:
        paths = [tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(
                     spec_tree)[0]]
    else:
        paths = list(leaf_paths(spec_tree))
    return paths, [_at(other, p) for p in paths]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_and_placements_equal_the_jax_packages(arch, shape):
    jcell = jax_build_cell(jax_arch(arch), JAX_SHAPES[shape])
    cell = build_cell(get_arch(arch), SHAPES[shape])
    assert (cell.name, cell.kind, cell.donate_argnums) == (
        jcell.name, jcell.kind, jcell.donate_argnums)
    assert len(cell.arg_specs) == len(jcell.arg_specs)
    fakes = [_fake(*m) for m in FAKE_MESHES]
    port_specs = [cell.in_specs(f) for f in fakes]
    for i, (js, ps) in enumerate(zip(jcell.arg_specs, cell.arg_specs)):
        jpaths, jleaves = _flat(js, js, True)
        paths, leaves = _flat(ps, ps, False)
        assert jpaths == paths, (arch, shape, i)
        for jl, tl in zip(jleaves, leaves):
            assert tuple(jl.shape) == tuple(tl.shape)
            jd, td = str(jl.dtype), str(tl.dtype).replace("torch.", "")
            assert td == jd or (jd, td) == ("int32", "int64"), (jd, td)
        _, jaxes = _flat(js, jcell.arg_axes[i], True)
        _, axes = _flat(ps, cell.arg_axes[i], False)
        assert [tuple(a) for a in jaxes] == [tuple(a) for a in axes]
        for f, pspec in zip(fakes, port_specs):
            ctx = jcell.context(f)
            want = [tuple(jax_resolve(lf.shape, ax, ctx))
                    for lf, ax in zip(jleaves, jaxes)]
            _, got = _flat(ps, pspec[i], False)
            assert want == [tuple(g) for g in got], (arch, shape, i)


def test_build_cell_defaults_follow_the_reference():
    """Dense attention up to 8192 tokens, blockwise above; decode cells
    donate the caches."""
    cfg = get_arch("qwen3-8b")
    assert build_cell(cfg, SHAPES["train_4k"]).model.opt.attn_impl == "dense"
    assert build_cell(cfg, SHAPES["decode_32k"]).model.opt.attn_impl == \
        "blockwise"
    cell = build_cell(cfg, SHAPES["decode_32k"])
    assert cell.donate_argnums == (1,) and cell.arg_specs[0]["embed"].is_meta


# --------------------------------------------------- (b) the cells on gloo
FAMILY_ARCHS = {"dense": "qwen3-8b", "moe": "mixtral-8x7b",
                "ssm": "mamba2-780m", "hybrid": "recurrentgemma-2b",
                "encdec": "whisper-base", "vlm": "llava-next-34b"}


def _case(family):
    arch = FAMILY_ARCHS.get(family, family)
    return dict(tag=family.replace("-", "_"), arch=arch,
                factor=4.0 if family == "moe" else None)


JOBS = {
    "1x4": dict(mesh=[1, 4], axes=["data", "model"],
                families=list(FAMILY_ARCHS)),
    "2x2": dict(mesh=[2, 2], axes=["data", "model"],
                families=list(FAMILY_ARCHS)),
    "2x1x2": dict(mesh=[2, 1, 2], axes=["pod", "data", "model"],
                  families=["dense", "granite-3-2b"]),
}
CELL_CASES = [(job, f) for job, spec in JOBS.items()
              for f in spec["families"]]


def _jax_cfg(case):
    return case_cfg(jax_arch(case["arch"]).reduced(), case)


def _jax_logits(case, tree):
    """JAX model.prefill then T teacher-forced decode_steps on one
    device: (B, 1 + T, V) float32."""
    jcfg = _jax_cfg(case)
    jm = jax_build(jcfg, JaxOptions(attn_impl="flash", dtype=jnp.float32,
                                    scan_layers=False))
    params = jax.tree.map(jnp.asarray, tree)
    inputs = case_inputs(jcfg)
    toks = jnp.asarray(inputs["tokens"], jnp.int32)
    batch = {"tokens": toks[:, :S]}
    for k in ("frames", "patches"):
        if k in inputs:
            batch[k] = jnp.asarray(inputs[k])
    n0, ring = case_lengths(jcfg)
    prefill = jax.jit(jm.prefill, static_argnames="max_len")
    decode = jax.jit(jm.decode_step)
    lg, caches = prefill(params, batch, max_len=ring)
    out = [np.asarray(lg, np.float32)]
    for t in range(T):
        lg, caches = decode(params, toks[:, S + t:S + t + 1], caches,
                            jnp.asarray(n0 + t, jnp.int32))
        out.append(np.asarray(lg, np.float32))
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Each job spawned once (lazily): {job: (ranks' results, the JAX
    logits of each case)}."""
    runs = {}

    def get(job):
        if job in runs:
            return runs[job]
        spec = JOBS[job]
        wd = tmp_path_factory.mktemp(f"serve_{job}")
        cases, want = [], {}
        for fam in spec["families"]:
            case = _case(fam)
            jcfg = _jax_cfg(case)
            tree = numpy_params(jax_build(jcfg, JaxOptions(
                dtype=jnp.float32, scan_layers=False)))
            cfg = case_cfg(get_arch(case["arch"]).reduced(), case)
            port = params_from_jax(tree, cfg, ModelOptions(
                dtype=torch.float32, scan_layers=False), "cpu")
            np.savez(wd / f"{case['tag']}.npz",
                     **{f"leaf{i}": t.numpy()
                        for i, t in enumerate(tree_leaves(port))})
            want[case["tag"]] = _jax_logits(case, tree)
            cases.append(case)
        job_spec = dict(mesh=spec["mesh"], axes=spec["axes"],
                        serve_cells=dict(mesh=spec["mesh"],
                                         axes=spec["axes"], cases=cases))
        if job == "1x4":
            job_spec["flash_decode"] = {"windows": [None, 32]}
        runs[job] = (spawn(job_spec, None, wd, SPAWN_DEADLINE_S), want)
        return runs[job]

    return get


@pytest.mark.parametrize("job,family", CELL_CASES)
def test_cells_on_gloo_match_jax(serve_runs, job, family):
    ranks, want = serve_runs(job)
    tag = _case(family)["tag"]
    for r, out in enumerate(ranks):
        got = out[f"{tag}_logits"]
        assert got.shape == want[tag].shape, (r, got.shape)
        np.testing.assert_allclose(got, want[tag], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{job} {family} rank {r}")
        assert out[f"{tag}_param_blocks_ok"] and out[f"{tag}_cache_blocks_ok"]
        held, blocks = out[f"{tag}_param_bytes"]
        assert held == blocks, (r, held, blocks)
        held, blocks = out[f"{tag}_cache_bytes"]
        assert held == blocks, (r, held, blocks)
        if job == "1x4":
            assert out[f"{tag}_param_blocks_coincide"], r
            assert out[f"{tag}_cache_blocks_coincide"], r
        else:
            # "embed" and "head_dim" go to "data" under SERVE_RULES, "batch"
            # leaves it: the blocks move between the cells
            assert not out[f"{tag}_param_blocks_coincide"], r


def test_cells_issue_the_expected_collectives(serve_runs):
    """(2, 2): the prefill places each attention layer's keys and values
    with one all-to-all each (KV heads split over "model", slots too);
    Mixtral's experts take two all-to-alls a layer in the prefill and,
    at decode (the batch of 2 divides the 2 ranks of "model"), two a
    step and layer. (1, 4): the reduced models' 2 KV heads are
    replicated, so the prefill cuts its slot block locally; the batch of
    2 does not divide 4, so Mixtral's decode takes the dense dispatch on
    the rank's experts, all-reduced. Every attention layer's decode step
    is one sharded flash-decode."""
    ranks, _ = serve_runs("2x2")
    layers = get_arch("qwen3-8b").reduced().num_layers
    for out in ranks:
        assert int(out["dense_prefill_a2a"]) == 2 * layers
        assert int(out["dense_flash_decode_calls"]) == T * layers
        assert int(out["moe_prefill_a2a"]) == 2 * 2 * layers
        assert int(out["moe_a2a"]) == 2 * 2 * layers + 2 * T * layers
    ranks, _ = serve_runs("1x4")
    for out in ranks:
        assert int(out["dense_prefill_a2a"]) == 0
        assert int(out["moe_a2a"]) == 2 * layers
        assert int(out["dense_flash_decode_calls"]) == T * layers


# ------------------------------------------------- (c) the flash-decode alone
def _jax_flash_decode(window, tmp_path):
    """The reference's decode_attention under a (1, 4) sharding context on
    4 forced host devices (its sharded flash-decode), over FD["steps"]
    steps: (b, steps, d) float32."""
    cfg = flash_decode_cfg()
    p, x = flash_decode_inputs(cfg)
    np.savez(tmp_path / "fd.npz", x=x, **p)
    code = f"""
    import dataclasses, numpy as np, jax, jax.numpy as jnp
    from repro.config.registry import get_arch
    from repro.launch.mesh import make_mesh
    from repro.models import attention as attn
    from repro.sharding.rules import use_sharding

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), num_layers=1)
    z = np.load({str(tmp_path / "fd.npz")!r})
    p = {{k: jnp.asarray(z[k]) for k in z.files if k != "x"}}
    x = jnp.asarray(z["x"])
    mesh = make_mesh((1, 4), ("data", "model"))
    cache = attn.make_cache(cfg, {FD["b"]}, {FD["w"]}, jnp.float32)

    def step(x1, cache, t):
        with use_sharding(mesh):
            return attn.decode_attention(p, x1, cfg, cache, t,
                                         window={window!r})
    step = jax.jit(step)
    ys = []
    for t in range(x.shape[1]):
        y, cache = step(x[:, t:t + 1], cache, jnp.asarray(t, jnp.int32))
        ys.append(np.asarray(y))
    np.save({str(tmp_path / "y.npy")!r}, np.concatenate(ys, axis=1))
    """
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return np.load(tmp_path / "y.npy")


@pytest.mark.parametrize("window", [None, 32])
def test_flash_decode_matches_the_reference(serve_runs, window, tmp_path):
    ranks, _ = serve_runs("1x4")
    want = _jax_flash_decode(window, tmp_path)
    blind = np.stack([out[f"fd_w{window}_blind"] for out in ranks])
    assert blind.any(axis=0).sum() > 0      # a step with a rank seeing none
    if window is not None:   # rank 0's slots (positions 0-15) pass out
        assert blind[0, -1]
    for r, out in enumerate(ranks):
        got = out[f"fd_w{window}_y"]
        assert float(np.max(np.abs(got - want))) < 2e-4, r
        assert float(out[f"fd_w{window}_vs_dense"]) < 2e-4, r


def test_ring_rows_place_the_prefill_as_prefill_attention_does():
    """``_ring_rows`` (the slots a rank's block takes of a prefill) equals
    ``prefill_attention``'s ring, below and past the ring's length."""
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), num_layers=1)
    gen = torch.Generator().manual_seed(0)
    for s, w in ((5, 8), (8, 8), (13, 8)):
        k = torch.randn((2, s, cfg.num_kv_heads, cfg.resolved_head_dim),
                        generator=gen)
        cache = {"k": torch.zeros((2, w) + k.shape[2:]),
                 "v": torch.zeros((2, w) + k.shape[2:]),
                 "pos": torch.zeros((w,), dtype=torch.int64)}
        # the reference write, through prefill_attention's own code
        pos1 = torch.arange(s)
        if s >= w:
            slots = pos1[-w:] % w
            cache["k"][:, slots] = k[:, -w:]
            cache["pos"][slots] = pos1[-w:]
        else:
            cache["k"][:, :s] = k
            cache["pos"][:s] = pos1
        for lo, size in ((0, w), (0, w // 2), (w // 2, w // 2)):
            rows, pos = attn._ring_rows(k, w, lo, size)
            assert torch.equal(rows, cache["k"][:, lo:lo + size]), (s, lo)
            assert torch.equal(pos, cache["pos"][lo:lo + size]), (s, lo)


def test_serve_plan_rejects_a_train_cell():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import ServePlan

    cell = build_cell(get_arch("qwen3-8b").reduced(), SHAPES["train_4k"])
    with pytest.raises(ValueError, match="prefill or decode"):
        ServePlan(cell, make_mesh((1, 1), ("data", "model"), "cpu"))


def test_one_rank_cells_equal_the_model_bit_for_bit():
    """On a one-rank ("data", "model") mesh the cells are
    ``model.prefill`` / ``decode_step`` bit for bit (chip_smoke.py phase
    29 holds the same on the card at Qwen3-8B's widths)."""
    from _torch_serve import cells, one_rank_logits

    from repro_torch.checkpoint.elastic import cut
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import cell_step, relayout

    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    for arch in ("qwen3-8b", "mamba2-780m", "recurrentgemma-2b"):
        cfg = get_arch(arch).reduced()
        opts = ModelOptions(attn_impl="flash", dtype=torch.float32,
                            scan_layers=arch == "mamba2-780m")
        pre, dec = cells(cfg, opts)
        ps, ds = cell_step(pre, mesh), cell_step(dec, mesh)
        params = pre.model.init(0, "cpu")
        blocks = ps.plan.init_params(params=params, device="cpu")
        inputs = case_inputs(cfg)
        want = one_rank_logits(pre.model, params, inputs, "cpu")
        toks = torch.from_numpy(inputs["tokens"])
        lg, caches = ps(blocks, {"tokens": toks[:, :S]}, max_len=16)
        caches = relayout(caches, ps.plan.cache_shardings(16),
                          dec.in_shardings(mesh)[1], mesh)
        got = [lg]
        for t in range(T):
            lg, caches = ds(blocks, caches, cut(toks[:, S + t:S + t + 1],
                                                ds.plan.in_sh[2]), S + t)
            got.append(lg)
        assert np.array_equal(torch.cat(got, 1).numpy(), want), arch
