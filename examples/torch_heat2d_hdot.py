"""Heat2D with hierarchical over-decomposition on the PyTorch/CUDA port.

Shows the solver converging, the two schedules agreeing bit for bit, and
the tile sweep (the hand-written CUDA kernel on the card, its plain version
on the CPU) matching the plain blocked sweep: mesh shards -> subdomain
schedule -> tile.

Run:  PYTHONPATH=src python examples/torch_heat2d_hdot.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.domain import halo_fraction
from repro_torch.core.stencil import heat2d_init, heat2d_solve
from repro_torch.kernels.heat2d import ops as heat_ops
from repro_torch.launch.mesh import make_mesh


def ascii_field(u: torch.Tensor, width: int = 48) -> str:
    u = u.float().cpu()
    chars = " .:-=+*#%@"
    step = max(1, u.shape[0] // 16), max(1, u.shape[1] // width)
    rows = []
    lo, hi = float(u.min()), float(u.max()) + 1e-9
    for i in range(0, u.shape[0], step[0]):
        row = ""
        for j in range(0, u.shape[1], step[1]):
            v = (float(u[i, j]) - lo) / (hi - lo)
            row += chars[min(int(v * len(chars)), len(chars) - 1)]
        rows.append(row)
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # paper Table 1: the memory cost of NOT sharing memory
    print("paper Table 1 — halo share of allocated memory (128x128, 1-D):")
    for ranks in (2, 4, 8, 16, 32):
        _, _, frac = halo_fraction((128, 128), (ranks, 1))
        print(f"  {ranks:3d} ranks: {100*frac:5.1f}%")

    mesh = make_mesh((1,), ("data",), args.device)
    u0 = heat2d_init(128, 128, device=mesh.device)
    print("\ninitial field:")
    print(ascii_field(u0))

    for iters in (25, 100):
        u_hd, res = heat2d_solve(u0, mesh, ("data",), iters, mode="hdot")
        print(f"\nafter {iters} HDOT sweeps (residual {float(res[-1]):.3e}):")
        print(ascii_field(u_hd))

    u_tp, _ = heat2d_solve(u0, mesh, ("data",), 100, mode="two_phase")
    print(f"\ntwo_phase == hdot: {torch.equal(u_tp, u_hd)}")

    # the tile layer: blocked red-black Gauss-Seidel
    gen = torch.Generator().manual_seed(0)
    u = torch.randn((256, 256), generator=gen).to(mesh.device)
    got = heat_ops.heat2d_sweep(u, tile=(128, 128))
    want = heat_ops.heat2d_sweep(u.cpu(), tile=(128, 128), impl="plain")
    path = "CUDA kernel" if u.is_cuda else "plain version"
    print(f"tile sweep ({path}) == plain blocked sweep: "
          f"{torch.allclose(got.cpu(), want, atol=1e-6)}")


if __name__ == "__main__":
    main()
