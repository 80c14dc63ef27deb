"""The building blocks of the tensor-parallel cut of the recurrent,
encoder-decoder and VLM families, on gloo ranks and against the JAX
package's placements.

On ("data", "model") meshes (1, 2), (1, 4) and (2, 2), each rank runs the
blocks forward and backward and the same math on one rank
(``tests/_torch_dist.py`` ``run_tp_units``): the autograd all-reduce (sum
forward, sum backward) and the width-block narrow (``TPCut.cols``; its
backward pads zeros) within 1e-6; the grouped RMS norm (the rank's columns,
square sums all-reduced) equal to ``rms_norm`` over the whole width, and
the RG-LRU gates' reduce-scatter equal to the whole-width gates' block,
within float32 rounding (rtol 1e-5: the sums run in another order); a
gradient that reaches the all-reduces strided summed right, from a
contiguous tensor at every ``dist.all_reduce`` (NCCL refuses a strided
one; gloo does not).

``TPCut.for_model`` places Mamba-2's ``d_inner`` and SSD heads, the
RG-LRU width and the attention heads as the JAX package's
``resolve_pspec`` places the leaves that carry them, at the published
widths and in the reduced variants the training tests use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_dist import spawn
from test_torch_sharding import _fake

from repro.config.registry import get_arch as jax_arch
from repro.models.model import ModelOptions as JaxOptions
from repro.models.model import build_model as jax_build
from repro.sharding import rules as jrules
from repro_torch.config.registry import get_arch
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.sharding.rules import ShardingContext, rules_for
from repro_torch.sharding.tp import TPCut

SPAWN_DEADLINE_S = 120
JOBS = {"2": [[1, 2]], "4": [[1, 4], [2, 2]]}
UNITS = ("allreduce", "cols", "norm", "gates", "strided")
EXACT = ("allreduce", "cols", "strided")


@pytest.fixture(scope="module")
def unit_runs(tmp_path_factory):
    cache = {}

    def get(job):
        if job not in cache:
            meshes = JOBS[job]
            workdir = tmp_path_factory.mktemp(f"tpu{job}")
            cache[job] = spawn(dict(mesh=[int(job)],
                                    tp_units=dict(meshes=meshes)),
                               None, workdir, SPAWN_DEADLINE_S)
        return cache[job]
    return get


@pytest.mark.parametrize("job,mesh,unit", [
    pytest.param(job, m, u, id=f"{'x'.join(map(str, m))}-{u}")
    for job, ms in JOBS.items() for m in ms for u in UNITS])
def test_tp_block_matches_one_rank(unit_runs, job, mesh, unit):
    """Every rank's forward and (line-summed) gradients equal one rank's
    computation of the same function: within 1e-6 for the all-reduce
    (sums of two or four terms, perhaps in another order) and the narrow,
    within float32 rounding for the norm and the gates."""
    tag = "m" + "x".join(map(str, mesh))
    for out in unit_runs(job):
        got, want = out[f"{tag}_{unit}_got"], out[f"{tag}_{unit}_want"]
        assert got.shape == want.shape
        if unit in EXACT:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def _variant(cfg, heads=None, ssm_head_dim=None):
    kw = {}
    if heads:
        kw["num_heads"] = heads
    if ssm_head_dim:
        kw["ssm"] = dataclasses.replace(cfg.ssm, head_dim=ssm_head_dim)
    return dataclasses.replace(cfg, **kw)


def _jax_model_placed(jcfg, tp, path, dim):
    """Whether the JAX package's train rules place dim `dim` of the leaf
    at `path` (keys into layer 0 of the unrolled tree) on "model"."""
    ctx = jrules.ShardingContext(_fake((1, tp), ("data", "model")),
                                 jrules.rules_for("train"))
    spec = jax_build(jcfg, JaxOptions(scan_layers=False)).param_specs()
    for k in path:
        spec = spec[k]
    pspec = tuple(jrules.resolve_pspec(spec.shape, spec.axes, ctx))
    pspec += (None,) * (dim + 1 - len(pspec))
    e = pspec[dim]
    return e == "model" or (isinstance(e, tuple) and "model" in e)


CUTS = [  # (arch, reduced, overrides, tp)
    ("mamba2-780m", False, {}, 4), ("mamba2-780m", False, {}, 2),
    ("mamba2-780m", True, {}, 4),
    ("mamba2-780m", True, {"ssm_head_dim": 128}, 4),
    ("recurrentgemma-2b", False, {}, 4), ("recurrentgemma-2b", False, {}, 2),
    ("recurrentgemma-2b", True, {"heads": 6}, 4),
    ("recurrentgemma-2b", True, {"heads": 6}, 2),
    ("whisper-base", False, {}, 4), ("whisper-base", True, {}, 4),
    ("llava-next-34b", False, {}, 4), ("llava-next-34b", True, {}, 4)]


@pytest.mark.parametrize("arch,reduced,over,tp", CUTS)
def test_tp_cut_places_as_the_jax_rules(arch, reduced, over, tp):
    """Each placement the cut reads equals the JAX rules' placement of the
    leaf that carries it (layer 0; the hybrid's layer 2 is its local
    attention). Mamba-2 780M at tp 4 shards its 48 SSD heads (12 a rank)
    and its d_inner; with head dim 128 at reduced width the columns shard
    and the 2 heads do not; RecurrentGemma-2B's 10 heads replicate at tp
    4 and shard at tp 2, its KV head and never, its LRU width always."""
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    cfg, jcfg = _variant(cfg, **over), _variant(jcfg, **over)
    mesh = ProcessMesh(("data", "model"), (1, tp), 0, torch.device("cpu"))
    cut = TPCut.for_model(cfg, mesh, ShardingContext(mesh,
                                                     rules_for("train")))
    layer = ("layers", 0)
    want = {}
    if cfg.family == "ssm":
        want = dict(inner=_jax_model_placed(jcfg, tp, layer + ("ssm", "wx"),
                                            1),
                    ssm_heads=_jax_model_placed(
                        jcfg, tp, layer + ("ssm", "wdt"), 1))
    else:
        at = ("layers", 2) if cfg.family == "hybrid" else layer
        want = dict(heads=_jax_model_placed(jcfg, tp, at + ("attn", "wq"), 1),
                    kv_heads=_jax_model_placed(jcfg, tp, at + ("attn", "wk"),
                                               1),
                    mlp=_jax_model_placed(jcfg, tp, at + ("mlp", "gate"), 1))
        if cfg.family == "hybrid":
            want["lru"] = _jax_model_placed(jcfg, tp,
                                            layer + ("rglru", "w_in"), 1)
        if cfg.family == "encdec":
            enc = ("encoder", 0, "attn")
            assert _jax_model_placed(jcfg, tp, enc + ("wq",), 1) == cut.heads
            assert (_jax_model_placed(jcfg, tp, enc + ("wk",), 1)
                    == cut.kv_heads)
    assert {k: getattr(cut, k) for k in want} == want
    if (arch, reduced, over, tp) == ("mamba2-780m", False, {}, 4):
        assert cut.inner and cut.ssm_heads
    if (arch, reduced, over) == ("mamba2-780m", True, {"ssm_head_dim": 128}):
        assert cut.inner and not cut.ssm_heads
    if arch == "recurrentgemma-2b" and not reduced:
        assert cut.heads == (tp == 2) and not cut.kv_heads and cut.lru
