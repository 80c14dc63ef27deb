"""RK3 (CREAMS-like, paper §4.2) and HPCCG's CG (§4.3) in the port against
the JAX package on one device, and hdot against two_phase inside the port.

Inputs are made from a seed with numpy and handed to both packages. The
tolerances are the JAX suite's own (``tests/test_stencil_apps.py``): RK3
within rtol 1e-5, atol 1e-6, HPCCG's residual history within rtol 1e-4.
The packages are not bit-equal: XLA may fuse a multiply and an add, or sum
a dot product in another order. Inside the port both schedules do the same
IEEE operations per cell in the same order, and eager PyTorch fuses no
multiply-add, so hdot equals two_phase bit for bit, and so do the three
mesh topologies of one rank. The shapes are those of
``tests/test_stencil_apps.py`` and ``tests/test_halo_nd.py``, plus shapes
too thin for the pipelined schedules, so both branches of each solver run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import halo as jhalo
from repro.core import stencil as jst
from repro.launch.mesh import make_grid_mesh as jgrid_mesh
from repro.launch.mesh import make_mesh as jmesh
from repro_torch.core import halo as thalo
from repro_torch.core import stencil as tst
from repro_torch.launch.mesh import make_grid_mesh, make_mesh

RK3_TOL = dict(rtol=1e-5, atol=1e-6)
HIST_RTOL = 1e-4
AXES = {1: ("data",), 2: ("rows", "cols"), 3: ("planes", "rows", "cols")}


@pytest.fixture(scope="module")
def meshes():
    return {1: (jmesh((1,), ("data",)), make_mesh((1,), ("data",), "cpu")),
            2: (jgrid_mesh(1, 1), make_grid_mesh(1, 1, device="cpu")),
            3: (jgrid_mesh(1, 1, 1), make_grid_mesh(1, 1, 1, device="cpu"))}


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- RK3
# (shape, steps, dt): the JAX suite's cases; (12, 20, 32) takes the
# pipelined schedule on slabs and on the (1, 1) grid, (12, 12, 32) on slabs
# only (y < 16), (8, 8, 12) on neither (z < 16)
RK3_CASES = [((12, 12, 32), 5, 0.01), ((8, 8, 64), 20, 0.01),
             ((12, 20, 32), 4, 0.01), ((8, 8, 12), 3, 0.05)]


@pytest.fixture(scope="module")
def rk3_runs(meshes):
    cache = {}

    def get(n, case):
        key = (n, case)
        if key not in cache:
            shape, steps, dt = RK3_CASES[case]
            v0 = _data(shape, 30 + case)
            out = {}
            for mode in ("two_phase", "hdot"):
                want = jst.rk3_solve(jnp.asarray(v0), meshes[n][0], AXES[n],
                                     steps, dt=dt, mode=mode)
                got = tst.rk3_solve(_t(v0), meshes[n][1], AXES[n], steps,
                                    dt=dt, mode=mode)
                out[mode] = (np.asarray(want), got.numpy())
            cache[key] = (v0, out)
        return cache[key]
    return get


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("case", range(len(RK3_CASES)))
@pytest.mark.parametrize("n", [1, 2])
def test_rk3_matches_jax(rk3_runs, n, case, mode):
    _, out = rk3_runs(n, case)
    want, got = out[mode]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **RK3_TOL)


@pytest.mark.parametrize("case", range(len(RK3_CASES)))
@pytest.mark.parametrize("n", [1, 2])
def test_rk3_hdot_equals_two_phase_bitwise(rk3_runs, n, case):
    _, out = rk3_runs(n, case)
    np.testing.assert_array_equal(out["hdot"][1], out["two_phase"][1])


@pytest.mark.parametrize("case", range(len(RK3_CASES)))
def test_rk3_slabs_equal_the_grid_bitwise(rk3_runs, case):
    np.testing.assert_array_equal(rk3_runs(1, case)[1]["hdot"][1],
                                  rk3_runs(2, case)[1]["hdot"][1])


def test_rk3_diffusion_smooths(rk3_runs):
    """Periodic diffusion preserves the mean and contracts the variance
    (the JAX suite's check, same tolerance)."""
    v0, out = rk3_runs(1, 1)
    v = out["hdot"][1]
    assert v.std() < v0.std()
    np.testing.assert_allclose(v.mean(), v0.mean(), atol=1e-4)


def test_rk3_zero_steps_returns_the_block(meshes):
    v0 = _data((4, 4, 16), 3)
    for mode in ("two_phase", "hdot"):
        got = tst.rk3_solve(_t(v0), meshes[2][1], AXES[2], 0, mode=mode)
        np.testing.assert_array_equal(got.numpy(), v0)


def test_rk3_pipelined_step_equals_plain_step(meshes):
    """Carrying the exchanges across stages changes when the messages go,
    not what a stage computes: one pipelined step (its fill issued ahead)
    equals one plain step, bit for bit, on slabs and on the grid."""
    v0 = _t(_data((6, 16, 24), 5))
    for n in (1, 2):
        mesh = meshes[n][1]
        pending = tst._rk3_start(v0, mesh, AXES[n])
        got, _ = tst.rk3_local_step_pipelined(v0, pending, mesh, AXES[n],
                                              0.02, exchange_last=False)
        want = tst.rk3_local_step(v0, mesh, AXES[n], 0.02, "two_phase")
        assert torch.equal(got, want)


def test_diff2_and_rhs_match_jax(meshes):
    padded = _data((12, 10, 20), 8)
    for dim in range(3):
        got = tst._diff2_dir(_t(padded), dim)
        want = jst._diff2_dir(jnp.asarray(padded), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RK3_TOL)
    v = _data((6, 20, 24), 9)
    want = jax.jit(jax.shard_map(
        lambda x: jst.rk3_rhs(x, ("rows", "cols"), "hdot"),
        mesh=meshes[2][0], in_specs=(P(None, "rows", "cols"),),
        out_specs=P(None, "rows", "cols")))(jnp.asarray(v))
    got = tst.rk3_rhs(_t(v), meshes[2][1], AXES[2], "hdot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RK3_TOL)


def test_rk3_constants_are_the_jax_float32_values():
    np.testing.assert_array_equal(np.float32(tst._C8),
                                  np.asarray(jst._C8, np.float32))
    np.testing.assert_array_equal(np.float32(tst._RK3_A),
                                  np.float32(jst._RK3_A))
    np.testing.assert_array_equal(np.float32(tst._RK3_B),
                                  np.float32(jst._RK3_B))


# ----------------------------------------------------------------- HPCCG
# (shape, iters): the JAX suite's cases; (16, 16, 16) and (10, 12, 12) take
# the pipelined schedule, (6, 6, 3) does not (z < 4)
HPCCG_CASES = [((16, 16, 16), 30), ((10, 12, 12), 15), ((6, 6, 3), 8)]


@pytest.fixture(scope="module")
def hpccg_runs(meshes):
    cache = {}

    def get(case):
        if case not in cache:
            shape, iters = HPCCG_CASES[case]
            b = _data(shape, 40 + case)
            _, want = jst.hpccg_solve(jnp.asarray(b), meshes[1][0], ("data",),
                                      iters, mode="two_phase")
            out = {}
            for n in (1, 2, 3):
                for mode in ("two_phase", "hdot"):
                    x, h = tst.hpccg_solve(_t(b), meshes[n][1], AXES[n],
                                           iters, mode=mode)
                    out[(n, mode)] = (x.numpy(), h.numpy())
            cache[case] = (b, np.asarray(want), out)
        return cache[case]
    return get


@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(HPCCG_CASES)))
def test_hpccg_history_matches_jax(hpccg_runs, case, n, mode):
    _, want, out = hpccg_runs(case)
    x, h = out[(n, mode)]
    assert h.shape == (HPCCG_CASES[case][1],) and h.dtype == np.float32
    assert x.shape == HPCCG_CASES[case][0]
    np.testing.assert_allclose(h, want, rtol=HIST_RTOL)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(HPCCG_CASES)))
def test_hpccg_hdot_equals_two_phase_bitwise(hpccg_runs, case, n):
    _, _, out = hpccg_runs(case)
    for a, b in zip(out[(n, "hdot")], out[(n, "two_phase")]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", range(len(HPCCG_CASES)))
def test_hpccg_meshes_of_one_rank_agree_bitwise(hpccg_runs, case):
    """Slabs, a pair and a triple of size-1 axes see the same zero ghosts
    through the face chain: same bits."""
    _, _, out = hpccg_runs(case)
    for n in (2, 3):
        for a, b in zip(out[(n, "hdot")], out[(1, "hdot")]):
            np.testing.assert_array_equal(a, b)


def test_hpccg_converges(hpccg_runs):
    _, _, out = hpccg_runs(0)
    h = out[(1, "hdot")][1]
    assert h[-1] < 1e-3 * h[0]


def test_hpccg_solution_solves_system(meshes):
    """A x ~= b for the returned x after 60 iterations (the JAX suite's
    bound); the port's operator agrees with the JAX package's on x."""
    b = _data((12, 12, 12), 3)
    for n in (1, 3):
        x, _ = tst.hpccg_solve(_t(b), meshes[n][1], AXES[n], 60, mode="hdot")
        ax = tst._stencil27_matvec(x, None, (), "hdot")
        rel = float(torch.linalg.norm(ax - _t(b)) / torch.linalg.norm(_t(b)))
        assert rel < 1e-3
        want = jst._stencil27_matvec(jnp.asarray(x.numpy()), None, "hdot")
        np.testing.assert_allclose(ax.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_hpccg_zero_iterations(meshes):
    b = _data((4, 4, 8), 1)
    x, h = tst.hpccg_solve(_t(b), meshes[1][1], AXES[1], 0)
    assert h.shape == (0,) and not x.any()


def test_sum27_matches_jax():
    q = _data((7, 9, 11), 12)
    got = tst._sum27(_t(q))
    want = jst._sum27(jnp.asarray(q))
    assert got.shape == (5, 7, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("size,subdomains", [(4096, 4), (1001, 4), (7, 3),
                                             (3, 4)])
def test_ddot_matches_jax(size, subdomains):
    """The flat product is cut as jnp.array_split cuts it (uneven chunks,
    and more chunks than elements); each chunk summed in f32, then the
    task-level tree. Sums of another order: within 1e-5 relative."""
    a, b = _data((size,), 1), _data((size,), 2)
    got = tst._ddot(_t(a), _t(b), None, (), subdomains)
    want = jst._ddot(jnp.asarray(a), jnp.asarray(b), None, subdomains)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    chunks = torch.tensor_split(torch.arange(size), subdomains)
    want_sizes = [len(c) for c in np.array_split(np.arange(size),
                                                 subdomains)]
    assert [len(c) for c in chunks] == want_sizes


# ---------------------------------------------- the halo building blocks
@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("decomp", [
    ((0, None), (1, None), (2, None)),            # all local pads
    ((0, None), (1, "rows"), (2, "cols")),        # the (y, z) grid's RHS
    ((2, "cols"), (0, None)),                     # sharded first
])
def test_multi_dim_stencil_matches_jax(meshes, decomp, periodic, mode):
    u = _data((10, 20, 24), 21)
    spec = P(None, "rows", "cols")
    want = jax.jit(jax.shard_map(
        lambda x: jhalo.multi_dim_stencil(x, jst._diff2_dir, decomp, 4,
                                          periodic, mode),
        mesh=meshes[2][0], in_specs=(spec,), out_specs=spec))(jnp.asarray(u))
    got = thalo.multi_dim_stencil(_t(u), tst._diff2_dir, meshes[2][1],
                                  decomp, 4, periodic, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RK3_TOL)
    if mode == "hdot":   # the schedules agree bit for bit
        other = thalo.multi_dim_stencil(_t(u), tst._diff2_dir, meshes[2][1],
                                        decomp, 4, periodic, "two_phase")
        assert torch.equal(got, other)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dim,width", [(0, 1), (1, 2), (2, 4)])
def test_pad_with_halo_matches_jax(meshes, dim, width, periodic):
    u = _data((6, 8, 10), 4)
    axis = ("planes", "rows", "cols")[dim]
    spec = P(*AXES[3])
    want = jax.jit(jax.shard_map(
        lambda x: jhalo.pad_with_halo(x, axis, width, dim, periodic),
        mesh=meshes[3][0], in_specs=(spec,), out_specs=spec))(jnp.asarray(u))
    got = thalo.pad_with_halo(_t(u), meshes[3][1], axis, width, dim,
                              periodic)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,dims,subdomains", [
    ((6, 20, 24), (2,), (4,)), ((6, 20, 24), (1, 2), (3, 2)),
    ((6, 3, 24), (1,), (2,)),                   # degenerate: no interior
])
def test_stencil_with_exchange_equals_stencil_with_halo(meshes, shape, dims,
                                                        subdomains):
    """The in-flight form (interior first, then wait, then faces) returns
    the bits of the same form on halos already received, and of the JAX
    package's received-halo form within float32 rounding."""
    u = _t(_data(shape, 6))
    mesh = meshes[3][1]
    axes = tuple((AXES[3][d], d) for d in dims)

    def fn(p):  # a width-1 star over the dims in `dims`
        core = [slice(1, -1) if e in dims else slice(None) for e in range(3)]
        acc = 0.0
        for d in dims:
            for off in (0, 2):
                idx = list(core)
                idx[d] = slice(off, p.shape[d] - 2 + off)
                acc = acc + p[tuple(idx)]
        return 0.25 * acc

    halos = thalo.exchange_halo_nd(u, mesh, axes, 1, True)
    want = thalo.stencil_with_exchange_nd(
        u, [thalo.HaloExchange(lo, hi) for lo, hi in halos], fn, 1, dims,
        subdomains)
    pending = thalo._start_halo_nd(u, mesh, axes, 1, True)
    got = thalo.stencil_with_exchange_nd(u, pending, fn, 1, dims, subdomains)
    assert torch.equal(got, want)
    jwant = jhalo.stencil_with_halo_nd(
        jnp.asarray(u.numpy()),
        [tuple(jnp.asarray(h.numpy()) for h in pair) for pair in halos],
        fn, 1, dims, subdomains)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------- contract and device
def test_contract_errors(meshes):
    v = _t(_data((4, 4, 16), 0))
    with pytest.raises(ValueError, match="takes 1 or 2"):
        tst.rk3_solve(v, meshes[3][1], AXES[3], 1)
    with pytest.raises(ValueError, match="bare string"):
        tst.rk3_solve(v, meshes[1][1], "data", 1)
    with pytest.raises(ValueError, match="3-D"):
        tst.rk3_solve(v[0], meshes[1][1], AXES[1], 1)
    with pytest.raises(ValueError, match="3-D"):
        tst.hpccg_solve(v[0], meshes[1][1], AXES[1], 1)
    with pytest.raises(ValueError, match="unknown overlap mode"):
        tst.hpccg_solve(v, meshes[1][1], AXES[1], 1, mode="eager")
    with pytest.raises(ValueError, match="unknown overlap mode"):
        tst.rk3_solve(v, meshes[1][1], AXES[1], 1, mode="eager")


@pytest.mark.parametrize("n", [1, 2, 3])
def test_hpccg_unknown_mode_raises_on_every_topology(meshes, n):
    """The JAX package raises on slabs but runs an unknown mode as
    two_phase on (y, z) and (x, y, z) meshes; the port raises on all three
    (ROADMAP Queue 3)."""
    b = _t(_data((6, 6, 8), 0))
    with pytest.raises(ValueError, match="unknown overlap mode"):
        tst.hpccg_solve(b, meshes[n][1], AXES[n], 3, mode="eager")


def test_solvers_run_on_the_mesh_device_and_cuda_raises(meshes):
    """The solvers compute on the mesh's device; a CUDA mesh without CUDA
    raises instead of falling back."""
    v = _t(_data((4, 4, 16), 0))
    assert tst.rk3_solve(v, meshes[2][1], AXES[2], 1).device.type == "cpu"
    x, h = tst.hpccg_solve(v, meshes[3][1], AXES[3], 2)
    assert x.device.type == "cpu" and h.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_grid_mesh(1, 1)


@pytest.mark.parametrize("dims,shape", [((2,), (4, 6, 8)),
                                        ((1, 2), (4, 6, 8)),
                                        ((0, 1, 2), (4, 6, 8))])
def test_local_block_and_gather_on_one_rank(meshes, dims, shape):
    u = _t(_data(shape, 2))
    mesh = meshes[len(dims)][1]
    axes = AXES[len(dims)]
    blk = tst.local_block(u, mesh, axes, dims)
    assert torch.equal(blk, u)
    assert torch.equal(tst.gather_global(blk, mesh, axes, shape, dims), u)
    with pytest.raises(ValueError, match="decomposed dims"):
        tst.local_block(u, mesh, axes, dims[1:] or (0, 1))
