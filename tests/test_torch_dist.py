"""The port on several gloo ranks on the CPU against the JAX package on one
device: heat2d_solve on 2 ranks (2,), 4 ranks (4,) and a (2, 2) grid in both
schedules, the sharded tile sweep on (2, 2), and the peeled hdot scan with
its exchanges counted per axis.

Each job spawns its ranks as separate processes (``tests/_torch_dist.py``,
which imports no jax) with a FileStore of their own in a temporary
directory and one thread each; the whole spawn has a deadline, so a hung
rendezvous fails its tests instead of stalling the suite. The parent makes
the input with numpy, computes the JAX reference on one device and compares
the gathered global results. The stencils here add first and multiply by
0.25 last, so every backend does the same IEEE operations in the same order
and the comparisons are exact.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import _star, _sum3, spawn
from repro.core import halo as jhalo
from repro.core import stencil as jst
from repro.launch.mesh import make_grid_mesh as jgrid_mesh
from repro.launch.mesh import make_mesh as jmesh
from repro_torch.kernels.heat2d.ops import heat2d_sweep

SHAPE = (48, 40)
ITERS, SCAN_STEPS = 10, 4
SPAWN_DEADLINE_S = 180

JOBS = {
    # 2 ranks: slabs; the periodic scan has both messages on one peer
    "2": dict(mesh=[2], axes=["data"]),
    # 4 ranks: slabs, a skewed cut; the scan on (4, 1) has a size-1 axis
    "4": dict(mesh=[4], axes=["data"],
              chunk_weights=[[5.0] * 3 + [1.0] * 7],
              scan_mesh=[4, 1], scan_axes=["rows", "cols"]),
    # a (2, 2) grid: blocks, a skewed cut, the sharded tile sweep
    "2x2": dict(mesh=[2, 2], axes=["rows", "cols"],
                chunk_weights=[[9.0] * 6 + [1.0] * 16, None],
                sweep_tile=[8, 10], sweep_sweeps=2),
}


def _spawn(name: str, workdir: Path):
    u0 = np.random.default_rng(11).uniform(0.0, 1.0, SHAPE).astype(
        np.float32)
    job = dict(JOBS[name], iters=ITERS, scan_steps=SCAN_STEPS)
    return u0, spawn(job, u0, workdir, SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _spawn(name, tmp_path_factory.mktemp(f"job{name}"))
        return cache[name]
    return get


def _jax_mesh(axes):
    return jmesh((1,), ("data",)) if len(axes) == 1 else jgrid_mesh(1, 1)


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("name", list(JOBS))
def test_heat2d_solve_ranks_match_jax(runs, name, mode):
    u0, ranks = runs(name)
    axes = tuple(JOBS[name]["axes"])
    want, wres = jst.heat2d_solve(jnp.asarray(u0), _jax_mesh(axes), axes,
                                  ITERS, "two_phase")
    for out in ranks:  # every rank gathered the same global grid
        np.testing.assert_array_equal(out[f"solve_{mode}"], np.asarray(want))
        np.testing.assert_array_equal(out[f"res_{mode}"], np.asarray(wres))
        np.testing.assert_array_equal(out["solve_hdot"],
                                      out["solve_two_phase"])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", list(JOBS))
def test_peeled_scan_matches_jax_and_counts_exchanges(runs, name, periodic):
    """`s` hdot steps issue exactly `s` exchanges per axis of size > 1 (one
    fill plus s - 1 in the loop, none in the peeled drain) and none on a
    size-1 axis; the result equals the JAX scan of the global grid."""
    u0, ranks = runs(name)
    job = JOBS[name]
    axes = tuple(job.get("scan_axes", job["axes"]))
    sizes = job.get("scan_mesh", job["mesh"])
    fn = _star if len(axes) == 2 else _sum3
    scan_axes = tuple((a, d) for d, a in enumerate(axes))
    spec = P(*axes) if len(axes) == 2 else P(axes[0])
    want, _ = jax.jit(jax.shard_map(
        lambda x: jhalo.halo_scan_nd(x, fn, scan_axes, 1, SCAN_STEPS,
                                     periodic, "hdot", 2),
        mesh=_jax_mesh(axes), in_specs=(spec,),
        out_specs=(spec, P())))(jnp.asarray(u0))
    tag = "periodic" if periodic else "open"
    expect = [SCAN_STEPS if s > 1 else 0 for s in sizes]
    for out in ranks:
        np.testing.assert_array_equal(out[f"scan_{tag}"], np.asarray(want))
        assert out[f"sends_{tag}"].tolist() == expect


def test_sweep_sharded_2x2_matches_global_sweep(runs):
    u0, ranks = runs("2x2")
    job = JOBS["2x2"]
    want = heat2d_sweep(torch.from_numpy(u0), tuple(job["sweep_tile"]),
                        job["sweep_sweeps"]).numpy()
    for out in ranks:
        np.testing.assert_array_equal(out["sweep"], want)
