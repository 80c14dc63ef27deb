"""Serving launcher: batched prefill + decode over a reduced config.

The port of ``repro/launch/serve.py``, with its flags and output lines plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels). ``--scheduler continuous`` (default) runs continuous batching
(token-granular slot re-admission, ``runtime/server.py:run_continuous``);
``--scheduler wave`` runs the static wave baseline. Attention runs through
the flash kernel (``attn_impl="flash"``), the path this port serves with.
Every family the server admits serves: dense GQA (``qwen3-8b``), MoE
(``qwen3-moe-30b-a3b``, ``mixtral-8x7b``), Mamba-2 (``mamba2-780m``) and
RecurrentGemma (``recurrentgemma-2b``). The encoder-decoder and VLM
families (``whisper-base``, ``llava-next-34b``) need frames or patches
with each prompt, which the server's token-only admission does not take:
it raises ``NotImplementedError`` for them, as the JAX package's
continuous scheduler does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--scheduler", choices=("continuous", "wave"),
                    default="continuous",
                    help="continuous = token-granular slot re-admission; "
                         "wave = static batches decoded to the slowest member")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import BatchServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash"))
    params = model.init(0, args.device)
    server = BatchServer(model, params, slots=args.slots, max_len=256)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
        server.submit(Request(prompt=prompt, max_new_tokens=args.max_new))
    if args.scheduler == "continuous":
        served = server.run_continuous()
    else:
        served = server.run_all()
    for i, r in enumerate(served):
        print(f"[serve] req{i:02d} -> {len(r.output)} tokens: {r.output[:8]}...")
    how = (f"{server.stats['decode_steps']} decode steps"
           if args.scheduler == "continuous"
           else f"{server.stats['waves']} waves")
    print(f"[serve] served {len(served)} requests ({args.scheduler}: {how})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
