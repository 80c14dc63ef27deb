"""End-to-end training on the PyTorch/CUDA port: a decoder LM with
the full stack (synthetic-but-learnable data, AdamW, microbatch
accumulation, async atomic checkpoints, exact restart).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --preset 20m --steps 200
      PYTHONPATH=src python examples/torch_train_lm.py --preset 2m --steps 4 --device cpu
"""
import argparse
import math

from repro_torch.config.base import (ModelConfig, ParallelConfig, RunConfig,
                                     TrainConfig)

PRESETS = {
    # ~101M params: 2*16k*640 emb + 10*(4*640^2 + 3*640*2560) = 101.4M
    "100m": dict(d_model=640, num_layers=10, num_heads=10, num_kv_heads=5,
                 d_ff=2560, vocab_size=16000, seq_len=256, global_batch=8),
    "20m": dict(d_model=320, num_layers=6, num_heads=8, num_kv_heads=4,
                d_ff=1280, vocab_size=8000, seq_len=128, global_batch=8),
    "2m": dict(d_model=128, num_layers=2, num_heads=4, num_kv_heads=2,
               d_ff=512, vocab_size=1024, seq_len=64, global_batch=8),
}


def build_run(preset: str, steps: int, ckpt_dir: str, accum: int) -> RunConfig:
    p = dict(PRESETS[preset])
    seq_len = p.pop("seq_len")
    global_batch = p.pop("global_batch")
    cfg = ModelConfig(name=f"lm-{preset}", family="dense", qk_norm=True, **p)
    return RunConfig(
        model=cfg,
        parallel=ParallelConfig(remat="none", accum_steps=accum),
        train=TrainConfig(global_batch=global_batch, seq_len=seq_len,
                          lr=2e-3, warmup_steps=max(10, steps // 20),
                          total_steps=steps,
                          checkpoint_every=max(10, steps // 10),
                          checkpoint_dir=ckpt_dir, seed=0),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/torch_train_lm")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.runtime.trainer import Trainer

    run = build_run(args.preset, args.steps, args.ckpt_dir, args.accum)
    n_params = run.model.num_params()
    print(f"[torch_train_lm] {run.model.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps, batch {run.train.global_batch} x "
          f"seq {run.train.seq_len}, device {args.device}")
    trainer = Trainer(run, device=args.device)
    if args.resume:
        trainer.restore_if_available()
        print(f"[torch_train_lm] resumed at step {trainer.step}")
    result = trainer.train(args.steps - trainer.step)
    losses = [m["loss"] for m in trainer.metrics_log]
    k = max(1, len(losses) // 10)
    print(f"[torch_train_lm] loss first-{k}-avg={sum(losses[:k])/k:.4f} "
          f"last-{k}-avg={sum(losses[-k:])/k:.4f}")
    print(f"[torch_train_lm] {result['seconds']:.1f}s total, "
          f"{result['seconds']/max(1, result['steps']):.2f}s/step")
    # the improvement check is meaningful only after the LR warmup; a run
    # inside it gets a sanity bound: finite and near ln(vocab)
    warm = run.train.warmup_steps
    assert all(math.isfinite(l) for l in losses), "loss diverged"
    if len(losses) > warm + 2 * k:
        post = losses[warm:]
        assert (sum(post[-k:]) / k
                < sum(post[:k]) / k), "post-warmup loss did not improve"
        print("[torch_train_lm] OK — post-warmup loss decreased")
    else:
        bound = math.log(run.model.vocab_size) + 1.5
        assert losses[-1] < bound, f"loss {losses[-1]:.3f} above {bound:.3f}"
        print(f"[torch_train_lm] OK — run inside warmup ({len(losses)} <= "
              f"{warm} + 2*{k} steps); loss sane (< ln(vocab)+1.5)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
