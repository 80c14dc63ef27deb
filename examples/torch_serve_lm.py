"""Batched serving on the PyTorch/CUDA port: continuous batching over a
reduced qwen3-8b (prefill once, decode in slots, EOS early exit). On the
card the prefill runs the hand-written flash-attention kernel.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.config.registry import get_arch
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.runtime.server import BatchServer, Request


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_arch("qwen3-8b").reduced()
    impl = "flash" if device.type == "cuda" else "dense"
    model = build_model(cfg, ModelOptions(attn_impl=impl))
    params = model.init(0, device)
    server = BatchServer(model, params, slots=4, max_len=128)

    rng = np.random.default_rng(7)
    n_req = 10
    for i in range(n_req):
        server.submit(Request(
            prompt=rng.integers(1, cfg.vocab_size, 8 + i).tolist(),
            max_new_tokens=12))

    t0 = time.time()
    served = server.run_all()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in served)
    for i, r in enumerate(served):
        print(f"req{i:02d} prompt_len={len(r.prompt):2d} -> "
              f"{len(r.output)} new tokens: {r.output}")
    assert len(served) == n_req and all(len(r.output) == 12 for r in served)
    print(f"\n{len(served)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {device}, reduced config)")


if __name__ == "__main__":
    main()
