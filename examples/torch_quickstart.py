"""Quickstart on the PyTorch/CUDA port: the HDOT idea in 60 lines.

1. ONE partition scheme (`decompose_grid`) reused at process level (mesh
   shards) and task level (subdomains).
2. A stencil solve under the two schedules: two_phase (exchange, barrier,
   compute) and hdot (boundary/interior split, messages in flight while the
   interior computes), identical numbers.
3. The same discipline on an LM: per-bucket gradient reductions.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.config.registry import get_arch
from repro_torch.core.domain import Domain, decompose_grid
from repro_torch.core.overlap import make_buckets
from repro_torch.core.stencil import heat2d_init, heat2d_solve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ModelOptions, build_model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print("== 1. one scheme, two levels ==")
    boxes = decompose_grid((128, 128), (4, 1))          # process level
    print(f"process level: {len(boxes)} domains, shapes "
          f"{sorted({b.shape for b in boxes})}")
    dom = Domain.for_rank((128, 128), (4, 1), rank=1)
    subs = dom.over_decompose((4, 1))                   # task level
    n_boundary = sum(1 for s in subs if s.is_boundary(dim=0))
    print(f"task level:    {len(subs)} subdomains per domain, "
          f"{n_boundary} of them boundary (own a comm task)")

    print("\n== 2. Heat2D: two_phase vs hdot ==")
    mesh = make_mesh((1,), ("data",), args.device)
    u0 = heat2d_init(128, 128, device=mesh.device)
    u_tp, res_tp = heat2d_solve(u0, mesh, ("data",), iters=50,
                                mode="two_phase")
    u_hd, res_hd = heat2d_solve(u0, mesh, ("data",), iters=50, mode="hdot")
    print(f"residual after 50 sweeps: two_phase={float(res_tp[-1]):.3e} "
          f"hdot={float(res_hd[-1]):.3e}")
    print(f"fields identical: {torch.equal(u_tp, u_hd)}")

    print("\n== 3. gradient domain over-decomposition ==")
    cfg = get_arch("internlm2-1.8b").reduced()
    model = build_model(cfg, ModelOptions(attn_impl="dense"))
    params = model.init(0, mesh.device)
    buckets = make_buckets(params, 8)
    sizes = [sum(l.numel() for _, l in b) for b in buckets]
    print(f"{len(tree_leaves(params))} gradient leaves -> {len(buckets)} "
          f"size-balanced buckets (subdomains): {sizes}")
    print("each bucket is an independent all-reduce issued during the "
          "backward, no two-phase barrier.")


if __name__ == "__main__":
    main()
