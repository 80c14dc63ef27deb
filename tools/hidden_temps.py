"""Find the aten operations of a training step that allocate, on the card,
memory their outputs do not account for: the kernels' own scratch, which
the dry run's fake pass (``analysis/fake_run.py``) cannot see and so names
in ``_HIDDEN_TEMPS``.

    PYTHONPATH=src python3 tools/hidden_temps.py
    PYTHONPATH=src python3 tools/hidden_temps.py --arch qwen3-8b --layers 2

Builds a Trainer as ``chip_smoke.py``'s phase 30 does (bf16, remat "full",
unrolled, AdamW, 8 x 2048 tokens a step, no mesh; the arch at its
published widths cut to ``--layers`` layers, seed 0), takes one step,
then a second under a ``TorchDispatchMode`` that resets the card's peak
counter before every aten operation and reads it after: an operation's
scratch is its peak over the larger of the bytes allocated before and
after it. Prints one JSON line: the step's peak over the bytes held
before it and the operation at which it was reached, each operation
whose scratch passed 64 MiB with the largest scratch seen, and the first
of their calls with each input's shape, strides, contiguity and dtype;
and the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30


class _Scratch(TorchDispatchMode):
    def __init__(self, dev, threshold: int):
        super().__init__()
        self.dev, self.threshold = dev, threshold
        self.largest, self.first = {}, {}
        self.peak, self.at = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        out = func(*args, **(kwargs or {}))
        after = torch.cuda.memory_allocated(self.dev)
        peak = torch.cuda.max_memory_allocated(self.dev)
        name = str(func)
        scratch = peak - max(before, after)
        if scratch > self.threshold:
            self.largest[name] = max(self.largest.get(name, 0), scratch)
            self.first.setdefault(name, [
                [list(a.shape), list(a.stride()), a.is_contiguous(),
                 str(a.dtype)] for a in args if isinstance(a, torch.Tensor)])
        if peak > self.peak:
            self.peak, self.at = peak, name
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hidden_temps: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = torch.cuda.memory_allocated(dev)
    t = chip_smoke.train_run("hdot", None, dev=dev, arch=args.arch,
                             scan=False, steps=4, layers=args.layers,
                             remat="full")
    t.init_state(seed=0)
    t.train(1)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) - base
    mode = _Scratch(dev, 64 * 2 ** 20)
    with mode:
        t.train(1)
    torch.cuda.synchronize(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(json.dumps({
        "arch": args.arch, "layers": args.layers,
        "held_before_step_gib": held / GIB,
        "step_peak_gib": (mode.peak - base) / GIB, "peak_at": mode.at,
        "scratch_gib": {k: v / GIB for k, v in sorted(
            mode.largest.items(), key=lambda kv: -kv[1])},
        "first_call_inputs": mode.first, "gpu": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
