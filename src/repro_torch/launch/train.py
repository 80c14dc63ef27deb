"""Training launcher: ``--arch <id>`` + mesh flags -> Trainer loop.

The port of ``repro/launch/train.py``, with its flags and output lines plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU). It runs the
reduced config unless ``--full``. ``--mesh none`` (default) trains without
a mesh, ``single-device`` on a one-rank ("data", "model") mesh;
``production`` and ``production-multipod`` build a mesh over the
ranks a launcher such as ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; one card per rank, ``LOCAL_RANK``):
("data", "model") of (world, 1), or ("pod", "data", "model") of (2,
world / 2, 1). ``--model-axis M`` gives the "model" axis M ranks instead
of 1: (world / M, M), or (2, world / (2 M), M), and every family then
trains tensor-parallel, the MoE family's experts over the M ranks (the
JAX package's production mesh has a 16-wide "model" axis, which a few
ranks cannot hold, so the width is stated).
``--restarts N`` runs the fault-tolerant runner: a failed step restarts
from the latest checkpoint, up to N times.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --device cpu --steps 4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-8b --mesh production --model-axis 2 --device cpu --steps 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch mamba2-780m --mesh production --model-axis 2 --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
from repro_torch.config.registry import get_arch


def build_run(arch: str, *, reduced: bool = True, steps: int = 50,
              global_batch: int = 8, seq_len: int = 128,
              checkpoint_dir: Optional[str] = None,
              overlap: str = "hdot", accum_steps: int = 1) -> RunConfig:
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if checkpoint_dir is None:
        checkpoint_dir = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    # namespace per arch: a shared dir would otherwise restore a FOREIGN
    # checkpoint into a mismatched param tree
    checkpoint_dir = f"{checkpoint_dir.rstrip('/')}/{cfg.name}"
    return RunConfig(
        model=cfg,
        parallel=ParallelConfig(overlap=overlap, accum_steps=accum_steps,
                                remat="none" if reduced else "full"),
        train=TrainConfig(global_batch=global_batch, seq_len=seq_len,
                          total_steps=steps, warmup_steps=max(1, steps // 10),
                          checkpoint_every=max(1, steps // 5),
                          checkpoint_dir=checkpoint_dir),
    )


def _launched_mesh(multi_pod: bool, device: str, model_axis: int = 1):
    """A mesh over the ranks of the environment's process group, with
    `model_axis` ranks on its "model" axis (1: DP only)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--mesh production needs a launcher's "
                           f"environment (torchrun): {missing} not set")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    pods = 2 if multi_pod else 1
    if model_axis < 1 or world % (pods * model_axis):
        raise ValueError(f"--model-axis {model_axis} does not divide the "
                         f"{world} ranks into {pods} pod(s)")
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    # env:// reads MASTER_ADDR and MASTER_PORT (and joins torchrun's own
    # store where the launcher runs one)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=world)
    data = world // (pods * model_axis)
    if multi_pod:
        return make_mesh((2, data, model_axis), ("pod", "data", "model"),
                         device)
    return make_mesh((data, model_axis), ("data", "model"), device)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--mesh", choices=["none", "single-device", "production",
                                       "production-multipod"], default="none")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the 'model' axis of a production mesh "
                         "(tensor parallelism; default 1: data parallel)")
    ap.add_argument("--overlap", choices=["hdot", "two_phase"], default="hdot")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: repro_ckpt under the temp directory")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--restarts", type=int, default=0,
                    help="fault-tolerant restarts budget")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    if args.model_axis != 1 and not args.mesh.startswith("production"):
        raise ValueError("--model-axis needs --mesh production or "
                         "production-multipod")
    mesh = None
    if args.mesh == "single-device":
        mesh = make_mesh((1, 1), ("data", "model"), args.device)
    elif args.mesh in ("production", "production-multipod"):
        mesh = _launched_mesh(args.mesh == "production-multipod", args.device,
                              args.model_axis)

    run = build_run(args.arch, reduced=not args.full, steps=args.steps,
                    global_batch=args.global_batch, seq_len=args.seq_len,
                    checkpoint_dir=args.checkpoint_dir, overlap=args.overlap,
                    accum_steps=args.accum_steps)
    try:
        if args.restarts:
            from repro_torch.runtime.ft import FaultTolerantRunner

            runner = FaultTolerantRunner(
                lambda: Trainer(run, mesh=mesh, device=args.device),
                max_restarts=args.restarts)
            trainer = runner.run(args.steps)
            print(f"[train] reached step {trainer.step} "
                  f"({runner.restarts} restarts used)")
        else:
            trainer = Trainer(run, mesh=mesh, device=args.device)
            if args.resume:
                trainer.restore_if_available()
            result = trainer.train(args.steps)
            print(f"[train] {result}")
        losses = [m["loss"] for m in trainer.metrics_log]
        if losses:
            print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
