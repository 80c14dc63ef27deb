"""Heat2D in the port against the JAX package: the solver, its cut
canonicalization, the re-cut driver, the plain tile sweep against the Pallas
kernel in interpret mode, the device contract and the import boundary.

Inputs are made with numpy (or by the JAX package and exported with
``np.asarray``) and handed to both packages. The Heat2D arithmetic is the
same IEEE operations in the same order on both sides (additions, then a
multiplication by 0.25), so grids and residuals are compared bit for bit;
the bf16 sweep is compared within one bf16 ulp after the cast, as stated
where it is.
"""
from __future__ import annotations

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil as jst
from repro.kernels.heat2d import ops as jops
from repro.launch.mesh import make_grid_mesh as jgrid_mesh
from repro.launch.mesh import make_mesh as jmesh
from repro.runtime.rebalance import heat2d_solve_rebalanced as jrebalanced
from repro_torch.core import stencil as tst
from repro_torch.kernels.heat2d import ops as tops
from repro_torch.kernels.heat2d import ref as tref
from repro_torch.launch.mesh import make_grid_mesh, make_mesh
from repro_torch.runtime.rebalance import heat2d_solve_rebalanced

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def meshes():
    return {"1": (jmesh((1,), ("data",)), make_mesh((1,), ("data",), "cpu"),
                  ("data",)),
            "1x1": (jgrid_mesh(1, 1), make_grid_mesh(1, 1, device="cpu"),
                    ("rows", "cols"))}


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _grid(kind, n=32):
    if kind == "blob":
        return np.array(jst.heat2d_init(n, n))
    return np.random.default_rng(7).uniform(0.0, 1.0, (n, n)).astype(
        np.float32)


SKEW = {"1": ([9.0] * 8 + [1.0] * 22,),
        "1x1": ([9.0] * 8 + [1.0] * 22, [1.0] * 10 + [3.0] * 20)}


# ------------------------------------------------------------- the solver
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["two_phase", "hdot"])
@pytest.mark.parametrize("mesh_key", ["1", "1x1"])
@pytest.mark.parametrize("kind", ["blob", "random"])
def test_heat2d_solve_matches_jax(meshes, mesh_key, mode, weighted, kind):
    jm, tm, axes = meshes[mesh_key]
    u0 = _grid(kind)
    cw = SKEW[mesh_key] if weighted else None
    want, wres = jst.heat2d_solve(jnp.asarray(u0), jm, axes, 12, mode, 4,
                                  chunk_weights=cw)
    got, res = tst.heat2d_solve(torch.from_numpy(u0), tm, axes, 12, mode, 4,
                                chunk_weights=cw)
    assert tuple(res.shape) == (12,)
    _eq(got, want)
    _eq(res, wres)
    other = "hdot" if mode == "two_phase" else "two_phase"
    got2, res2 = tst.heat2d_solve(torch.from_numpy(u0), tm, axes, 12, other,
                                  4, chunk_weights=cw)
    assert torch.equal(got, got2) and torch.equal(res, res2)


def test_heat2d_one_sweep_is_the_5_point_update(meshes):
    _, tm, axes = meshes["1x1"]
    u0 = _grid("blob")
    got, _ = tst.heat2d_solve(torch.from_numpy(u0), tm, axes, 1, "hdot")
    up = np.pad(u0, 1)
    want = 0.25 * (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2]
                   + up[1:-1, 2:])
    _eq(got, want)


def test_heat2d_residual_decreases(meshes):
    _, tm, axes = meshes["1"]
    _, res = tst.heat2d_solve(torch.from_numpy(_grid("blob", 64)), tm, axes,
                              50, "hdot")
    res = res.numpy()
    assert res[-1] < res[0]
    assert (np.diff(res) <= 1e-7).all()


@pytest.mark.parametrize("n", [8, 32, 40])
def test_heat2d_init_matches_jax(n):
    _eq(tst.heat2d_init(n, n + 3, device="cpu"), jst.heat2d_init(n, n + 3))


CUT_CASES = [
    ("1", 4, None), ("1", 4, ([1.0] * 30,)), ("1", 4, ([1] * 30,)),
    ("1", 4, ([9.0] * 8 + [1.0] * 22,)), ("1", 4, ((5, 25),)),
    ("1", 4, ((8, 8, 7, 7),)), ("1", 2, ((3, 9, 9, 9),)),
    ("1x1", 4, (None, None)), ("1x1", (4, 2), (None, [2.0] * 10 + [1.0] * 20)),
    ("1x1", (4, 2), ((10, 20), None)), ("1x1", 4, ([1.0] * 30, [5.0] * 30)),
]


@pytest.mark.parametrize("mesh_key,subdomains,weights", CUT_CASES)
def test_heat2d_cuts_match_jax(meshes, mesh_key, subdomains, weights):
    jm, tm, axes = meshes[mesh_key]
    assert (tst._heat2d_cuts((32, 32), tm, axes, subdomains, weights)
            == jst._heat2d_cuts((32, 32), jm, axes, subdomains, weights))


def test_heat2d_cuts_errors(meshes):
    _, tm, axes = meshes["1"]
    with pytest.raises(ValueError, match="chunk_weights"):
        tst.heat2d_solve(torch.zeros(32, 32), tm, axes, 2, "hdot", 4,
                         chunk_weights=([1.0] * 30, None))


def test_normalize_mesh_axes_contract():
    norm = tst.normalize_mesh_axes
    assert norm(("data",), "heat2d_solve", (1, 2)) == ("data",)
    assert norm(["rows", "cols"], "heat2d_solve", (1, 2)) == ("rows", "cols")
    for bad in ("data", ("a", "b", "c"), ("data", "data"), ("data", 1), 42,
                ()):
        with pytest.raises(ValueError, match="heat2d_solve"):
            norm(bad, "heat2d_solve", (1, 2))


# ------------------------------------------------------- the re-cut driver
def _cost_fn(idx, shape):
    return (4.0 if idx[0] == 0 else 1.0) * int(np.prod(shape)) * 1e-6


@pytest.mark.parametrize("mesh_key", ["1", "1x1"])
def test_rebalanced_matches_jax(meshes, mesh_key):
    jm, tm, axes = meshes[mesh_key]
    u0 = _grid("blob")
    want, wres, winfo = jrebalanced(jnp.asarray(u0), jm, axes, 12, "hdot", 4,
                                    rebalance_every=4, chunk_cost_fn=_cost_fn)
    got, res, info = heat2d_solve_rebalanced(
        torch.from_numpy(u0), tm, axes, 12, "hdot", 4, rebalance_every=4,
        chunk_cost_fn=_cost_fn)
    assert info["cut_history"] == winfo["cut_history"]
    assert info["recuts"] == winfo["recompiles"] >= 1
    assert len(info["segment_cuts"]) == 3
    _eq(got, want)
    _eq(res, wres)
    plain, pres = tst.heat2d_solve(torch.from_numpy(u0), tm, axes, 12)
    assert torch.equal(got, plain) and torch.equal(res, pres)


def test_rebalanced_static_without_signal(meshes):
    _, tm, axes = meshes["1"]
    u0 = torch.from_numpy(_grid("blob"))
    got, _, info = heat2d_solve_rebalanced(u0, tm, axes, 12, "hdot", 4,
                                           rebalance_every=4)
    assert info["recuts"] == 0
    assert torch.equal(got, tst.heat2d_solve(u0, tm, axes, 12)[0])
    with pytest.raises(ValueError, match="rebalance_every"):
        heat2d_solve_rebalanced(u0, tm, axes, 4, rebalance_every=-1)


# ----------------------------------------- carrying state across packages
def test_state_from_jax_carries_grid_halos_and_cuts(meshes):
    jm, _, axes = meshes["1x1"]
    rng = np.random.default_rng(5)
    grid = rng.standard_normal((18, 14)).astype(np.float32)
    halos = [(rng.standard_normal((1, 14)).astype(np.float32),
              rng.standard_normal((1, 14)).astype(np.float32)),
             (rng.standard_normal((18, 1)).astype(np.float32),
              rng.standard_normal((18, 1)).astype(np.float32))]
    cuts = jst._heat2d_cuts((32, 32), jm, axes, 4, SKEW["1x1"])
    st = tst.state_from_jax(grid, halos, cuts, device="cpu")
    assert st.cuts == cuts
    from repro.core.halo import stencil_with_halo_nd as jswh
    from repro_torch.core.halo import HaloExchange, stencil_with_exchange_nd

    want = jswh(jnp.asarray(grid), [tuple(map(jnp.asarray, h))
                                    for h in halos],
                jst._jacobi_stencil_2d, 1, (0, 1), (2, 3))
    got = stencil_with_exchange_nd(
        st.grid, [HaloExchange(lo, hi) for lo, hi in st.halos],
        tst._jacobi_stencil_2d, 1, (0, 1), (2, 3))
    _eq(got, want)


# ------------------------------------------- the sweep: plain vs Pallas
SWEEP_CASES = [  # (shape, tile, sweeps, halo)
    ((128, 128), (64, 64), 1, False), ((256, 256), (128, 128), 1, False),
    ((256, 256), (256, 256), 1, False),
    ((128, 128), (32, 64), 3, False), ((128, 128), (64, 64), 2, False),
    ((128, 128), (128, 128), 4, False),
    ((64, 96), (32, 32), 3, True),
    ((63, 45), (7, 9), 2, True),          # odd tile: tile-local parity
    ((48, 40), (256, 256), 2, False),     # tile clamped to the grid
]


def _sweep_inputs(shape, halo, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    ring = None
    if halo:
        nx, ny = shape
        ring = tuple(rng.standard_normal(s).astype(np.float32)
                     for s in ((1, ny), (1, ny), (nx, 1), (nx, 1)))
    return u, ring


@pytest.mark.parametrize("shape,tile,sweeps,halo", SWEEP_CASES)
def test_plain_sweep_matches_pallas_and_ref(shape, tile, sweeps, halo):
    u, ring = _sweep_inputs(shape, halo)
    jring = None if ring is None else tuple(map(jnp.asarray, ring))
    tring = None if ring is None else tuple(map(torch.from_numpy, ring))
    got = tops.heat2d_sweep(torch.from_numpy(u), tile, sweeps, "auto", tring)
    want_p = jops.heat2d_sweep(jnp.asarray(u), tile, sweeps, impl="pallas",
                               interpret=True, halo=jring)
    want_r = jops.heat2d_sweep(jnp.asarray(u), tile, sweeps, impl="ref",
                               halo=jring)
    _eq(got, want_p)
    _eq(got, want_r)


def test_plain_sweep_bf16_matches_pallas():
    """bf16 in, f32 inside, bf16 out, as the Pallas kernel does (the JAX
    `ref` oracle computes in bf16, so it is not the yardstick here). Within
    one bf16 ulp after the cast; in practice bit-equal."""
    u, ring = _sweep_inputs((64, 64), True)
    ub = torch.from_numpy(u).to(torch.bfloat16)
    tring = tuple(torch.from_numpy(h).to(torch.bfloat16) for h in ring)
    got = tops.heat2d_sweep(ub, (32, 32), 2, "plain", tring)
    assert got.dtype == torch.bfloat16
    jb = jnp.asarray(ub.float().numpy()).astype(jnp.bfloat16)
    jring = tuple(jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
                  for h in tring)
    want = np.asarray(jops.heat2d_sweep(jb, (32, 32), 2, impl="pallas",
                                        interpret=True, halo=jring)
                      .astype(jnp.float32))
    g = got.float().numpy()
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(np.float32(1), e - 8)
    assert (np.abs(g - want) <= ulp).all()


def test_sweep_ref_single_tile_matches_jax():
    from repro.kernels.heat2d.ref import heat2d_sweep_ref as jref

    padded = np.random.default_rng(9).standard_normal((34, 18)).astype(
        np.float32)
    padded[0, 0] = padded[0, -1] = padded[-1, 0] = padded[-1, -1] = 0.0
    _eq(tref.heat2d_sweep_ref(torch.from_numpy(padded), 3),
        jref(jnp.asarray(padded), 3))


def test_sweep_sharded_on_1x1_equals_sweep(meshes):
    jm, tm, _ = meshes["1x1"]
    u, _ = _sweep_inputs((64, 64), False)
    ut = torch.from_numpy(u)
    got = tops.heat2d_sweep_sharded(ut, tm, ("rows", "cols"), (32, 32), 2)
    assert torch.equal(got, tops.heat2d_sweep(ut, (32, 32), 2))
    _eq(got, jops.heat2d_sweep_sharded(jnp.asarray(u), jm, ("rows", "cols"),
                                       (32, 32), 2, impl="ref"))


# -------------------- the CUDA kernel's cluster path, emulated on the CPU
def _cluster_emulation(u, tile, sweeps, halo, nc):
    """``csrc/heat2d.cu``'s path "cluster_smem": each tile split into `nc`
    row bands (band r: rows [r * tx // nc, (r + 1) * tx // nc)), each band
    updated in place a colour at a time, its first and last rows reading
    the neighbouring band's current rows (the kernel reads them from that
    block's shared memory), the tile's own edges reading the frozen strips.
    Band by band, as the blocks may run in any order."""
    nx, ny = u.shape
    tx, ty = tile
    gx, gy = nx // tx, ny // ty
    v = u.float().reshape(gx, tx, gy, ty)
    if halo is None:
        hn = hs = v.new_zeros((ny,))
        hw = he = v.new_zeros((nx,))
    else:
        hn, hs, hw, he = (h.float().reshape(-1) for h in halo)
    north = torch.cat([hn.reshape(1, 1, gy, ty), v[:-1, -1:]], 0)
    south = torch.cat([v[1:, :1], hs.reshape(1, 1, gy, ty)], 0)
    west = torch.cat([hw.reshape(gx, tx, 1, 1), v[:, :, :-1, -1:]], 2)
    east = torch.cat([v[:, :, 1:, :1], he.reshape(gx, tx, 1, 1)], 2)
    cuts = [r * tx // nc for r in range(nc + 1)]
    rows = list(zip(cuts, cuts[1:]))
    bands = [v[:, i0:i1].clone() for i0, i1 in rows]
    jj = torch.arange(ty).reshape(1, 1, 1, ty)
    colour = [(torch.arange(i0, i1).reshape(1, -1, 1, 1) + jj) % 2
              for i0, i1 in rows]
    for _ in range(sweeps):
        for c in (0, 1):
            for r, (i0, i1) in enumerate(rows):
                s = bands[r]
                above = bands[r - 1][:, -1:] if r > 0 else north
                below = bands[r + 1][:, :1] if r < nc - 1 else south
                nb = torch.cat([above, s[:, :-1]], 1)               # N
                nb += torch.cat([s[:, 1:], below], 1)               # + S
                nb += torch.cat([west[:, i0:i1], s[:, :, :, :-1]], 3)   # + W
                nb += torch.cat([s[:, :, :, 1:], east[:, i0:i1]], 3)    # + E
                nb *= 0.25
                bands[r] = torch.where(colour[r] == c, nb, s)
    return torch.cat(bands, 1).reshape(nx, ny).to(u.dtype)


_PALLAS = {}


def _pallas_sweep(case, sweeps):
    """heat2d_sweep_pallas in interpret mode, once per case and sweeps."""
    if (case, sweeps) not in _PALLAS:
        shape, tile, _, halo = SWEEP_CASES[case]
        u, ring = _sweep_inputs(shape, halo)
        jring = None if ring is None else tuple(map(jnp.asarray, ring))
        _PALLAS[(case, sweeps)] = np.asarray(jops.heat2d_sweep(
            jnp.asarray(u), tile, sweeps, impl="pallas", interpret=True,
            halo=jring))
    return _PALLAS[(case, sweeps)]


@pytest.mark.parametrize("nc", [1, 2, 4, 8])
@pytest.mark.parametrize("case", range(len(SWEEP_CASES)))
def test_cluster_emulation_matches_pallas(case, nc):
    """Bit for bit, whatever the bands: the red-black order makes the
    update order within a colour, and so the band split, irrelevant."""
    shape, tile, sweeps, halo = SWEEP_CASES[case]
    tile = tuple(min(t, n) for t, n in zip(tile, shape))   # clamped
    u, ring = _sweep_inputs(shape, halo)
    tring = None if ring is None else tuple(map(torch.from_numpy, ring))
    got = _cluster_emulation(torch.from_numpy(u), tile, sweeps, tring,
                             min(nc, tile[0]))
    _eq(got, _pallas_sweep(case, sweeps))


@pytest.mark.parametrize("sweeps", range(5))
def test_cluster_emulation_odd_tile_all_sweep_counts(sweeps):
    """The odd (7, 9) tile: bands of 1 and 2 rows (4 blocks), 2 and 3
    rows (2 blocks), sweeps 0-4, against the Pallas kernel."""
    case = next(i for i, c in enumerate(SWEEP_CASES) if c[1] == (7, 9))
    shape, tile, _, halo = SWEEP_CASES[case]
    u, ring = _sweep_inputs(shape, halo)
    tring = tuple(map(torch.from_numpy, ring))
    want = _pallas_sweep(case, sweeps)
    for nc in (2, 4):
        _eq(_cluster_emulation(torch.from_numpy(u), tile, sweeps, tring, nc),
            want)


def test_sweep_contract_errors():
    u = torch.zeros((64, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.heat2d_sweep(u, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.heat2d_sweep(u, impl="pallas")
    with pytest.raises(ValueError, match="not divisible"):
        tops.heat2d_sweep(u, tile=(48, 48))
    with pytest.raises(ValueError, match="north/south"):
        tops.heat2d_sweep(u, halo=(torch.zeros(1, 63), torch.zeros(1, 64),
                                   torch.zeros(64, 1), torch.zeros(64, 1)))
    with pytest.raises(ValueError, match="west/east"):
        tops.heat2d_sweep(u, halo=(torch.zeros(1, 64), torch.zeros(1, 64),
                                   torch.zeros(64, 2), torch.zeros(64, 1)))
    with pytest.raises(ValueError, match="dtype"):
        tops.heat2d_sweep(u.double())


# ----------------------------------------------- device and import contract
def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    for call in (lambda: make_mesh((1,), ("data",)),
                 lambda: make_grid_mesh(1, 1),
                 lambda: tst.heat2d_init(8, 8),
                 lambda: tst.grid_from_numpy(np.zeros((2, 2), np.float32)),
                 lambda: tst.state_from_jax(np.zeros((2, 2), np.float32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 5
    files += examples
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
