"""The port on the card: the CUDA tile-sweep kernel against its plain
PyTorch version, the solver on CUDA against the CPU, and (given 4 cards)
NCCL ranks against one rank. Marked ``gpu``;
without a card every test here skips. Imports no jax, so it runs where the
JAX package is not installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

f32 is compared bit for bit (the kernel does the plain version's IEEE
operations in the same order, with no FMA contraction); bf16 within one
bf16 ulp after the cast.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.halo import halo_scan_nd
from repro_torch.core.stencil import heat2d_init, heat2d_solve
from repro_torch.kernels.heat2d import ops
from repro_torch.launch.mesh import make_grid_mesh, make_mesh

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


CASES = [  # (shape, tile, sweeps, halo, dtype)
    ((64, 64), (32, 32), 1, False, torch.float32),
    ((128, 96), (32, 48), 3, True, torch.float32),
    ((63, 45), (7, 9), 2, True, torch.float32),     # odd tile
    ((48, 40), (256, 256), 2, False, torch.float32),  # clamped tile
    ((64, 64), (16, 16), 0, False, torch.float32),
    ((64, 64), (16, 16), 2, True, torch.bfloat16),
]


@pytest.mark.parametrize("shape,tile,sweeps,halo,dtype", CASES)
def test_kernel_matches_plain(cuda, shape, tile, sweeps, halo, dtype):
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u = u.to(cuda, dtype)
    ring = None
    if halo:
        nx, ny = shape
        ring = tuple(torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda, dtype)
            for s in ((1, ny), (1, ny), (nx, 1), (nx, 1)))
    before = ops.heat2d_sweep.launches
    got = ops.heat2d_sweep(u, tile, sweeps, "kernel", ring)
    torch.cuda.synchronize()
    assert ops.heat2d_sweep.launches == before + 1
    want = ops.heat2d_sweep(u, tile, sweeps, "plain", ring)
    assert ops.heat2d_sweep.launches == before + 1
    assert got.dtype == dtype and got.shape == u.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        _, e = torch.frexp(want.float().abs())
        ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                          (e - 8).to(torch.int32))
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


def test_solver_on_card_equals_cpu(cuda):
    u0 = heat2d_init(64, 64, device="cpu")
    for mesh_fn, axes in ((lambda d: make_mesh((1,), ("data",), d),
                           ("data",)),
                          (lambda d: make_grid_mesh(1, 1, device=d),
                           ("rows", "cols"))):
        for mode in ("two_phase", "hdot"):
            got, res = heat2d_solve(u0.to(cuda), mesh_fn(cuda), axes, 8, mode)
            want, wres = heat2d_solve(u0, mesh_fn("cpu"), axes, 8, mode)
            assert got.is_cuda and res.is_cuda
            assert torch.equal(got.cpu(), want)
            assert torch.equal(res.cpu(), wres)


def test_sharded_sweep_launches_the_kernel(cuda):
    u = torch.randn((64, 64), device=cuda)
    before = ops.heat2d_sweep.launches
    got = ops.heat2d_sweep_sharded(u, make_grid_mesh(1, 1), ("rows", "cols"),
                                   (32, 32), 2)
    assert ops.heat2d_sweep.launches == before + 1
    assert torch.equal(got, ops.heat2d_sweep(u, (32, 32), 2, "plain"))


def test_nccl_2x2_ranks_match_one_rank(cuda, tmp_path):
    """Four NCCL ranks, one card each, on a (2, 2) grid: heat2d_solve in
    both schedules, the sharded sweep and the peeled scan equal one rank's
    results bit for bit, and the scan sends 4 exchanges per axis."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from _torch_dist import _star, spawn

    u0 = np.random.default_rng(11).uniform(0.0, 1.0, (48, 40)).astype(
        np.float32)
    job = dict(mesh=[2, 2], axes=["rows", "cols"], backend="nccl", iters=10,
               scan_steps=4, chunk_weights=[[9.0] * 6 + [1.0] * 16, None],
               sweep_tile=[8, 10], sweep_sweeps=2)
    ranks = spawn(job, u0, tmp_path, 300)
    one = make_grid_mesh(1, 1, device="cpu")
    ut = torch.from_numpy(u0)
    want, wres = heat2d_solve(ut, one, ("rows", "cols"), 10, "two_phase")
    sweep = ops.heat2d_sweep(ut, (8, 10), 2)
    scans = {tag: halo_scan_nd(ut, _star, one, (("rows", 0), ("cols", 1)), 1,
                               4, periodic, "hdot", 2)[0]
             for tag, periodic in (("open", False), ("periodic", True))}
    for out in ranks:
        for mode in ("two_phase", "hdot"):
            np.testing.assert_array_equal(out[f"solve_{mode}"], want.numpy())
            np.testing.assert_array_equal(out[f"res_{mode}"], wres.numpy())
        np.testing.assert_array_equal(out["sweep"], sweep.numpy())
        for tag, scan in scans.items():
            np.testing.assert_array_equal(out[f"scan_{tag}"], scan.numpy())
            assert out[f"sends_{tag}"].tolist() == [4, 4]
