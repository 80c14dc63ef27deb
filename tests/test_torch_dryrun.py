"""The port's dry run (``launch/dryrun.py``, ``Cell.lower``, the production
meshes, ``analysis/memtraffic.py``, ``analysis/roofline.py`` and
``analysis/fake_run.py``) against the JAX package.

(a) ``describe``, ``mesh_axis_size`` and ``validate_production_mesh``
give the reference's strings, sizes and errors; ``make_production_mesh``
builds (16, 16) and (2, 16, 16) over fake groups of 256 and 512 ranks.
(b) For every (arch, shape) on fake 16x16 and 2x16x16 meshes: whether
the cell runs (long_500k), ``sharded_bytes`` of every argument,
``hbm_traffic``, and the roofline of the cell equal the reference's (rel 1e-12; the reference's int32 leaves
counted at the port's int64 width, the one dtype the cells differ in);
``collective_wire_bytes`` and ``model_flops_for`` exactly.
(c) ``Cell.lower(...).compile()`` of a reduced dense train cell on one
rank counts the closed form of its GEMMs' FLOPs exactly, and its memory
analysis accounts for the step (arguments = the blocks, alias = the
parameters and moments updated in place, outputs = the new step counter
and metrics).
(d) The analysis pass's k0/k1 extrapolation equals the full-depth fake
pass exactly (FLOPs, bytes accessed, collective wire bytes), on a fake
(2, 2) group.
(e) ``python -m repro_torch.launch.dryrun`` on Mixtral-8x7B's decode_32k
cell at full width on 256 fake ranks (its 8 experts do not divide the
16-wide "model" axis: expert TP): rc 0, per-rank argument bytes equal to
the reference's ``sharded_bytes`` of the same cell, no all-to-all, and
``--report`` renders the table.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import memtraffic as jmem
from repro.config.registry import get_arch as jax_arch
from repro.config.shapes import SHAPES as JAX_SHAPES
from repro.config.shapes import cell_is_runnable as jax_runnable
from repro.launch import mesh as jmesh
from repro.launch.steps import build_cell as jax_build_cell
from repro_torch.analysis import memtraffic, roofline
from repro_torch.config.base import ParallelConfig
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.config.shapes import SHAPES, ShapeConfig, cell_is_runnable
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ModelOptions
from repro_torch.sharding.tp import TPCut

# the package's __init__ binds the name to its function
jroof = importlib.import_module("repro.analysis.roofline")
REPO = Path(__file__).resolve().parents[1]
PROD = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture
def fake_world():
    """Starts a fake default group of n ranks (``dryrun.fake_group``) and
    destroys it after the test."""
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_fake(shape, axes):
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object))


def _port_fake(shape, axes):
    return pmesh.ProcessMesh(axes, shape, 0, torch.device("cpu"))


# ------------------------------------------------------------ (a) meshes
@pytest.mark.parametrize("shape,axes", PROD + [((16, 8), ("data", "model")),
                                              ((4, 16, 16),
                                               ("pod", "data", "model"))])
def test_mesh_helpers_equal_the_jax_packages(shape, axes):
    j, p = _jax_fake(shape, axes), _port_fake(shape, axes)
    assert pmesh.describe(p) == jmesh.describe(j)
    for name in ("pod", "data", "model", "rows"):
        assert pmesh.mesh_axis_size(p, name) == jmesh.mesh_axis_size(j, name)
    for multi in (False, True):
        try:
            jmesh.validate_production_mesh(j, multi_pod=multi)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            pmesh.validate_production_mesh(p, multi_pod=multi)
        else:
            with pytest.raises(ValueError) as got:
                pmesh.validate_production_mesh(p, multi_pod=multi)
            assert str(got.value) == want


@pytest.mark.parametrize("multi", [False, True])
def test_make_production_mesh_on_a_fake_group(fake_world, multi):
    fake_world(512 if multi else 256)
    m = pmesh.make_production_mesh(multi_pod=multi, device="cpu")
    shape, axes = PROD[multi]
    assert (m.axis_names, m.sizes, m.rank, m.coords) == (
        axes, shape, 0, (0,) * len(shape))
    pmesh.validate_production_mesh(m, multi_pod=multi)
    for a, n in zip(axes, shape):
        assert dist.get_world_size(m.groups[a]) == n
    assert pmesh.describe(m) == jmesh.describe(_jax_fake(shape, axes))


# -------------------------------------------------- (b) the analytic terms
CELLS = [(a, s) for a in list_archs() for s in SHAPES]
JAX_HW = jroof.HW(name="nvidia-h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                  ici_bw=50e9, hbm_bytes=80e9)


def _widened(tree, port_tree):
    """The reference's spec leaves with each int32 leaf counted at the
    port's width for it (int64 for tokens, targets and ring positions)."""
    port = iter(tree_leaves(port_tree))

    def one(x):
        mine = next(port)
        dt = x.dtype
        if np.dtype(dt) == np.int32 and mine.dtype == torch.int64:
            dt = np.int64
        return SimpleNamespace(shape=tuple(x.shape), dtype=dt)
    return jax.tree.map(one, tree, is_leaf=lambda x: hasattr(x, "shape"))


def jax_arg_bytes(jcell, cell, mesh):
    """The reference's per-rank bytes of each argument of `jcell` on the
    mesh-like `mesh` (its int32 leaves at the port's `cell`'s width)."""
    ctx = jcell.context(mesh)
    return [jmem.sharded_bytes(_widened(s, ps), a, ctx)
            for s, ps, a in zip(jcell.arg_specs, cell.arg_specs,
                                jcell.arg_axes)]


def _rel(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_sharded_bytes_traffic_and_roofline_equal_the_jax_packages(arch,
                                                                    shape):
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    jcell = jax_build_cell(jcfg, JAX_SHAPES[shape])
    cell = build_cell(cfg, SHAPES[shape])
    sh = SHAPES[shape]
    # the dry run skips long_500k exactly where the reference's does
    assert cell_is_runnable(cfg.subquadratic, sh) == jax_runnable(
        jcfg.subquadratic, JAX_SHAPES[shape])
    for dims, axes in PROD:
        jm, pm = _jax_fake(dims, axes), _port_fake(dims, axes)
        ctx = cell.context(pm)
        want = jax_arg_bytes(jcell, cell, jm)
        got = [memtraffic.sharded_bytes(s, a, ctx)
               for s, a in zip(cell.arg_specs, cell.arg_axes)]
        assert all(_rel(g, w) for g, w in zip(got, want)), (got, want)
        chips = math.prod(dims)
        mb = 0.0
        if cell.kind == "train":
            mb = memtraffic.sharded_bytes(cell.arg_specs[1]["m"],
                                          cell.arg_axes[1]["m"], ctx) * 2
        cb = got[1] if cell.kind == "decode" else 0.0
        t = memtraffic.hbm_traffic(cfg, sh, chips, got[0], mb, cb,
                                   remat=cell.kind == "train")
        jt = jmem.hbm_traffic(jcfg, JAX_SHAPES[shape], chips, got[0], mb, cb,
                              remat=cell.kind == "train")
        assert _rel(t, jt)
        tokens = (sh.global_batch if sh.kind == "decode"
                  else sh.global_batch * sh.seq_len)
        mf = roofline.model_flops_for(cfg.active_params(), tokens, sh.kind)
        assert mf == jroof.model_flops_for(jcfg.active_params(), tokens,
                                           sh.kind)
        kw = dict(arch=arch, shape=shape, mesh="x".join(map(str, dims)),
                  chips=chips, hlo_flops=1e15 + chips, hlo_bytes=t,
                  coll_bytes=got[0] / 3, model_flops=mf, arg_bytes=sum(got),
                  temp_bytes=7e10, out_bytes=got[0])
        rep, jrep = roofline.RooflineReport(**kw), jroof.RooflineReport(
            hw=JAX_HW, **kw)
        assert rep.row() == jrep.row() and str(rep) == str(jrep)
        assert (rep.t_step_overlapped, rep.t_step_two_phase) == (
            jrep.t_step_overlapped, jrep.t_step_two_phase)


def test_wire_bytes_and_hardware_constants():
    for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                 "collective-permute", "broadcast"):
        for g in (1, 2, 16, 32, 256):
            for b in (0.0, 3.0, 2.0 ** 31 + 5):
                assert memtraffic.collective_wire_bytes(kind, b, g) == \
                    jmem.collective_wire_bytes(kind, b, g)
    hw = roofline.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 50e9, 80e9)
    assert roofline.roofline("a", "s", "m", 4, 1.0, 1.0, 1.0, 1.0).hw == hw


# -------------------------------------------------- (c) the fake pass
def _closed_form_flops(cfg, b, s) -> int:
    """The GEMM FLOPs of one dense train step (remat "none", dense
    attention, the fused loss): each projection's forward product and its
    two backward products (input, weight), the attention's two batched
    products over every (query, key) pair with their four backward
    products, and the head's logits three times (forward, the backward's
    recompute) plus its two backward products."""
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    t = b * s
    proj = 2 * t * d * (h * hd + 2 * kv * hd + h * hd + 3 * f)
    attn = 2 * 2 * b * h * s * s * hd
    layer = 3 * (proj + attn)
    head = 4 * 2 * t * d * cfg.vocab_size
    return cfg.num_layers * layer + head


def test_lower_counts_the_closed_form_gemms_of_a_dense_train_cell():
    cfg = get_arch("qwen3-8b").reduced()
    shape = ShapeConfig("t", 64, 2, "train")
    opts = ModelOptions(attn_impl="dense", scan_layers=False,
                        dtype=torch.float32)
    cell = build_cell(cfg, shape, opts, ParallelConfig(scan_layers=False))
    mesh = _port_fake((1, 1), ("data", "model"))
    compiled = cell.lower(mesh).compile()
    assert compiled.cost_analysis()["flops"] == _closed_form_flops(cfg, 2, 64)
    mem = compiled.memory_analysis()
    params = sum(x.numel() * 4 for x in tree_leaves(cell.arg_specs[0]))
    moments = 2 * params
    assert mem.argument_size_in_bytes == params + moments + 4 + 2 * 2 * 64 * 8
    # parameters and moments are updated in place; the step counter and
    # the three f32 metrics are new
    assert mem.alias_size_in_bytes == params + moments
    assert mem.output_size_in_bytes == 4 * 4
    assert mem.temp_size_in_bytes > 0
    assert compiled.collectives().ops == []
    assert compiled.op_counts()["matmul"] > 0


# ------------------------------------------- (d) the k0/k1 extrapolation
def test_analysis_extrapolation_equals_the_full_depth(fake_world):
    fake_world(4)
    mesh = pmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    base = get_arch("qwen3-8b").reduced()
    shape = ShapeConfig("t", 32, 4, "train")
    got = {}
    for k in (1, 2, base.num_layers):
        cfg = dataclasses.replace(base, num_layers=k)
        opts = ModelOptions(attn_impl="blockwise_unrolled", scan_layers=False,
                            remat="full")
        cell = build_cell(cfg, shape, opts,
                          ParallelConfig(scan_layers=False, remat="full"))
        got[k] = dryrun._extract(cell.lower(mesh).compile())
    L = base.num_layers
    for key in ("flops", "bytes_accessed", "coll_wire_bytes",
                "coll_operand_bytes"):
        per = (got[2][key] - got[1][key]) / 1
        assert got[2][key] + per * (L - 2) == got[L][key], key
    assert got[L]["coll_wire_bytes"] > 0
    assert set(got[L]["coll_by_kind"]) >= {"all-gather", "reduce-scatter",
                                           "all-reduce"}


# --------------------------------------------------- (e) the CLI
def test_dryrun_cli_serves_mixtral_decode_through_expert_tp(tmp_path):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "HOME": str(tmp_path)}
    out = tmp_path / "dr"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "mixtral-8x7b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads((out / "mixtral-8x7b__decode_32k__16x16.json")
                     .read_text())
    assert rec["ok"] and rec["world_size"] == 256
    jcell = jax_build_cell(jax_arch("mixtral-8x7b"), JAX_SHAPES["decode_32k"])
    cell = build_cell(get_arch("mixtral-8x7b"), SHAPES["decode_32k"])
    want = sum(jax_arg_bytes(jcell, cell, _jax_fake(*PROD[0])))
    assert rec["mem"]["argument_bytes"] == want
    assert "all-to-all" not in rec["coll_by_kind"]
    assert rec["coll_by_kind"]["all-reduce"][0] > 0
    assert rec["flops"] > 0 and "plain" in rec["impl"]
    cut = TPCut.for_model(cell.model.cfg, _port_fake(*PROD[0]),
                          cell.context(_port_fake(*PROD[0])))
    assert (cut.experts, cut.expert_cols) == (False, True)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--report", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "| mixtral-8x7b | decode_32k | 16x16 | ok |" in r.stdout


def test_tp_train_cut_runs_the_cells_attention(fake_world):
    """The TP train cut runs the cell's attention (``attn_impl``): on one
    rank, blockwise TP self-attention over 2048 rows (two chunks of 1024)
    equals the dense one within 1e-5; on a fake (1, 2) group the
    blockwise train cell counts the dense one's FLOPs and holds less
    temp (each chunk's scores, not the whole square)."""
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), num_layers=1)
    one = _port_fake((1, 1), ("data", "model"))
    cut = TPCut(one, "model", 1, 0, heads=True, kv_heads=True, mlp=True)
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s.shape, generator=gen) * 0.1 for k, s in
         attn.attention_specs(cfg, torch.float32).items()}
    x = torch.randn(1, 2048, cfg.d_model, generator=gen)
    dense, block = (attn.self_attention_tp(p, x, cfg, cut, None, impl)
                    for impl in ("dense", "blockwise"))
    torch.testing.assert_close(block, dense, rtol=1e-5, atol=1e-5)
    fake_world(2)
    mesh = pmesh.make_mesh((1, 2), ("data", "model"), device="cpu")
    got = {}
    for impl in ("dense", "blockwise"):
        cell = build_cell(cfg, ShapeConfig("t", 2048, 1, "train"),
                          ModelOptions(attn_impl=impl, scan_layers=False,
                                       dtype=torch.float32),
                          ParallelConfig(scan_layers=False))
        got[impl] = cell.lower(mesh).compile()
    assert got["blockwise"].cost_analysis()["flops"] == \
        got["dense"].cost_analysis()["flops"]
    assert got["blockwise"].memory_analysis().temp_size_in_bytes < \
        got["dense"].memory_analysis().temp_size_in_bytes
