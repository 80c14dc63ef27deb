"""The port's N-D halo family on one rank against the JAX package on one
device, and hdot against two_phase inside the port.

Inputs are made from a seed with numpy and handed to both packages. The
stencils are written once with slicing and arithmetic, so the same function
runs on jax arrays and on torch tensors. Tolerance is the JAX suite's own,
rtol = atol = 1e-6 in f32, and not bit-equality: these test stencils divide
by a constant, which XLA compiles to a multiplication by the reciprocal and
PyTorch does not, so the packages differ by up to one f32 ulp (1.2e-7 seen).
Inside the port, hdot and two_phase run the same arithmetic on the same
cells and must be exactly equal. Cases are those of ``tests/test_halo_nd.py``,
``tests/test_halo_2d.py`` and ``tests/test_halo_scan.py``, with non-periodic
variants and uneven weights.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import halo as jhalo
from repro.launch.mesh import make_grid_mesh as jgrid_mesh
from repro.launch.mesh import make_mesh as jmesh
from repro_torch.core import halo as thalo
from repro_torch.launch.mesh import make_grid_mesh, make_mesh

NAMES = {1: ("data",), 2: ("rows", "cols"), 3: ("planes", "rows", "cols")}
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def meshes():
    return {1: (jmesh((1,), ("data",)), make_mesh((1,), ("data",), "cpu")),
            2: (jgrid_mesh(1, 1), make_grid_mesh(1, 1, device="cpu")),
            3: (jgrid_mesh(1, 1, 1), make_grid_mesh(1, 1, 1, device="cpu"))}


def _avg3(p):
    """width-1 moving average along dim 0 (any trailing dims)."""
    return (p[:-2] + p[1:-1] + p[2:]) / 3.0


def _d2w2(p):
    """width-2 second difference along dim 0."""
    return p[:-4] - 0.5 * p[1:-3] + p[2:-2] - 0.5 * p[3:-1] + p[4:]


def _star(width, ndim):
    """Separable star stencil of `width` over `ndim` padded dims (reads the
    full cross, never a corner); returns the un-padded update."""
    def fn(p):
        w = width
        n = [s - 2 * w for s in p.shape[:ndim]]
        acc = 0.0
        for d in range(-w, w + 1):
            for k in range(ndim):
                idx = tuple(slice(w + (d if j == k else 0),
                                  w + (d if j == k else 0) + n[j])
                            for j in range(ndim))
                acc = acc + p[idx]
        return acc / (ndim * (2 * w + 1))
    return fn


def _fn(kind, width, ndim):
    return {"avg3": _avg3, "d2w2": _d2w2}.get(kind) or _star(width, ndim)


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _axes(ndim):
    return tuple(zip(NAMES[ndim], range(ndim)))


def _jax_run(body, mesh, ndim, u, n_out=1):
    spec = P(*NAMES[ndim])
    out_specs = spec if n_out == 1 else (spec, P())
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                                 out_specs=out_specs))(jnp.asarray(u))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


APPLY_CASES = (
    [(1, (24, 5), "avg3", s) for s in (1, 2, 3, 4, 16)]
    + [(2, (24, 20), "star", s) for s in ((1, 1), (2, 2), (3, 2), 4,
                                          (16, 16))]
    + [(3, (16, 14, 12), "star", s) for s in ((1, 1, 1), (2, 2, 2),
                                              (3, 2, 1), 2, (8, 8, 8))])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ndim,shape,kind,subdomains", APPLY_CASES)
def test_stencil_apply_nd_matches_jax(meshes, ndim, shape, kind, subdomains,
                                      periodic):
    jm, tm = meshes[ndim]
    fn = _fn(kind, 1, ndim)
    u = _data(shape, 0)
    axes = _axes(ndim)
    want = _jax_run(lambda x: jhalo.stencil_apply_nd(
        x, fn, axes, 1, periodic, "hdot", subdomains), jm, ndim, u)
    ut = torch.from_numpy(u)
    got = thalo.stencil_apply_nd(ut, fn, tm, axes, 1, periodic, "hdot",
                                 subdomains)
    two = thalo.stencil_apply_nd(ut, fn, tm, axes, 1, periodic, "two_phase")
    _close(got, want)
    assert torch.equal(got, two)


SCAN_CASES = [
    (1, (32, 4), "avg3", 1, 1, 5), (1, (32, 4), "d2w2", 2, 1, 5),
    (2, (17, 13), "star", 1, (3, 2), 4), (2, (16, 20), "star", 1, (3, 2), 4),
    (2, (21, 18), "star", 2, (3, 2), 4),
    (3, (11, 9, 13), "star", 1, (2, 2, 1), 3),
    (3, (12, 10, 8), "star", 1, (2, 2, 1), 3),
    (3, (13, 11, 10), "star", 2, (2, 2, 1), 3),
]


def _run_scan_both(meshes, ndim, shape, kind, width, subdomains, steps,
                   periodic, mode, weights=None):
    jm, tm = meshes[ndim]
    fn = _fn(kind, width, ndim)
    u = _data(shape, 1)
    axes = _axes(ndim)

    def jout(new, old):
        return jax.lax.pmax(jnp.max(jnp.abs(new - old)), NAMES[ndim])

    want, wres = _jax_run(lambda x: jhalo.halo_scan_nd(
        x, fn, axes, width, steps, periodic, mode, subdomains,
        step_out_fn=jout, weights=weights), jm, ndim, u, n_out=2)
    got, res = thalo.halo_scan_nd(
        torch.from_numpy(u), fn, tm, axes, width, steps, periodic, mode,
        subdomains, step_out_fn=lambda new, old: (new - old).abs().amax(),
        weights=weights)
    _close(got, want)
    _close(res, wres)
    return got, res


@pytest.mark.parametrize("mode", ["hdot", "two_phase"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ndim,shape,kind,width,subdomains,steps",
                         SCAN_CASES)
def test_halo_scan_nd_matches_jax(meshes, ndim, shape, kind, width,
                                  subdomains, steps, periodic, mode):
    got, res = _run_scan_both(meshes, ndim, shape, kind, width, subdomains,
                              steps, periodic, mode)
    assert tuple(res.shape) == (steps,)
    if mode == "hdot":
        _, tm = meshes[ndim]
        two, tres = thalo.halo_scan_nd(
            torch.from_numpy(_data(shape, 1)), _fn(kind, width, ndim), tm,
            _axes(ndim), width, steps, periodic, "two_phase", subdomains,
            step_out_fn=lambda new, old: (new - old).abs().amax())
        assert torch.equal(got, two) and torch.equal(res, tres)


@pytest.mark.parametrize("mode", ["hdot", "two_phase"])
@pytest.mark.parametrize("ndim,shape,width,weights", [
    (1, (32, 4), 1, ((10, 20),)),
    (2, (24, 20), 1, ((5, 17), (3, 6, 9))),
    (2, (24, 20), 1, (None, (1, 17))),
    (3, (16, 14, 12), 1, ((2, 12), None, (7, 3))),
])
def test_halo_scan_nd_uneven_weights_match_jax(meshes, ndim, shape, width,
                                               weights, mode):
    kind = "avg3" if ndim == 1 else "star"
    _run_scan_both(meshes, ndim, shape, kind, width, 2, 3, False, mode,
                   weights)


@pytest.mark.parametrize("ndim,shape,kind,width", [
    (1, (6, 3), "d2w2", 2), (2, (7, 12), "star", 2), (2, (3, 9), "star", 1)])
def test_degenerate_block_falls_back_and_matches_jax(meshes, ndim, shape,
                                                     kind, width):
    got, _ = _run_scan_both(meshes, ndim, shape, kind, width, 2, 3, True,
                            "hdot")
    _, tm = meshes[ndim]
    fn = _fn(kind, width, ndim)
    x = torch.from_numpy(_data(shape, 1))
    for _ in range(3):
        x = thalo.stencil_apply_nd(x, fn, tm, _axes(ndim), width, True,
                                   "two_phase")
    assert torch.equal(got, x)


@pytest.mark.parametrize("mode", ["hdot", "two_phase"])
def test_zero_steps_keeps_length_zero_history(meshes, mode):
    _, tm = meshes[2]
    u = torch.from_numpy(_data((16, 16), 2))
    got, res = thalo.halo_scan_nd(
        u, _star(1, 2), tm, _axes(2), 1, 0, mode=mode,
        step_out_fn=lambda new, old: (new - old).abs().amax())
    assert torch.equal(got, u) and tuple(res.shape) == (0,)
    got, res = thalo.halo_scan_nd(u, _star(1, 2), tm, _axes(2), 1, 0,
                                  mode=mode)
    assert res is None


@pytest.mark.parametrize("periodic", [False, True])
def test_exchange_size1_axes_match_jax(meshes, periodic):
    """Size-1 axes send nothing: periodic wraps the own edges, else
    zeros."""
    jm, tm = meshes[3]
    u = np.arange(2.0 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)

    def ex(x):
        return tuple(h for pair in jhalo.exchange_halo_nd(
            x, _axes(3), 1, periodic) for h in pair)

    want = jax.jit(jax.shard_map(
        ex, mesh=jm, in_specs=(P(*NAMES[3]),),
        out_specs=tuple(P(*NAMES[3]) for _ in range(6))))(jnp.asarray(u))
    got = [h for pair in thalo.exchange_halo_nd(
        torch.from_numpy(u), tm, _axes(3), 1, periodic) for h in pair]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ndim,shape,subdomains", [
    (2, (18, 14), (2, 3)), (3, (12, 10, 14), (2, 1, 3))])
def test_stencil_with_halo_nd_uses_given_halos(ndim, shape, subdomains):
    """Pre-exchanged random face halos flow into the right cells, corners
    included, identically in both packages."""
    u = _data(shape, 3)
    rng = np.random.default_rng(4)
    halos = []
    for d in range(ndim):
        shp = list(shape)
        shp[d] = 1
        halos.append((rng.standard_normal(shp).astype(np.float32),
                      rng.standard_normal(shp).astype(np.float32)))
    fn = _star(1, ndim)
    dims = tuple(range(ndim))
    want = jax.jit(functools.partial(
        jhalo.stencil_with_halo_nd, stencil_fn=fn, width=1, dims=dims,
        subdomains=subdomains))(jnp.asarray(u),
                                [tuple(map(jnp.asarray, h)) for h in halos])
    th = [tuple(map(torch.from_numpy, h)) for h in halos]
    got = thalo.stencil_with_exchange_nd(
        torch.from_numpy(u), [thalo.HaloExchange(lo, hi) for lo, hi in th],
        fn, 1, dims, subdomains)
    _close(got, want)
    padded = thalo.pad_with_halo_nd(torch.from_numpy(u), th, 1, dims)
    np.testing.assert_array_equal(
        padded.numpy(),
        np.asarray(jhalo.pad_with_halo_nd(
            jnp.asarray(u), [tuple(map(jnp.asarray, h)) for h in halos], 1,
            dims)))
    assert torch.equal(got, fn(padded))


def test_contract_errors(meshes):
    _, tm = meshes[2]
    u = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="overlap mode"):
        thalo.stencil_apply_nd(u, _star(1, 2), tm, _axes(2), 1, mode="x")
    with pytest.raises(ValueError, match="subdomains"):
        thalo.stencil_apply_nd(u, _star(1, 2), tm, _axes(2), 1,
                               subdomains=(2, 2, 2))
    with pytest.raises(ValueError, match="interior extent"):
        thalo.halo_scan_nd(u, _star(1, 2), tm, _axes(2), 1, 2,
                           weights=((3, 3), None))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_task_and_hdot_reduce_match_jax(meshes, op, n):
    """Same pairing order as the JAX tree, so sums agree bit for bit too;
    on one rank the process level is the identity."""
    from repro.core import reduction as jred
    from repro_torch.core import reduction as tred

    parts = _data((n, 3), 6)
    want = jred.task_reduce([jnp.asarray(p) for p in parts], op)
    got = tred.task_reduce([torch.from_numpy(p) for p in parts], op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, tm = meshes[2]
    assert torch.equal(tred.hdot_reduce([torch.from_numpy(p) for p in parts],
                                        tm, ("rows", "cols"), op), got)


def test_reduce_errors(meshes):
    from repro_torch.core import reduction as tred

    with pytest.raises(ValueError, match="at least one"):
        tred.task_reduce([], "max")
    with pytest.raises(ValueError, match="unknown reduction"):
        tred.task_reduce([torch.zeros(1)], "prod")
