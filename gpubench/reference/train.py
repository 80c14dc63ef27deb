"""The plain reference of a training step: a family's reference loss
(``reference/<family>.py``), its gradient by autograd over blocks of
rows, the clip to the global norm and AdamW with decoupled weight decay,
each parameter stored back in the dtype the configuration states. Float32
with TF32 off; the control computes every weight product in fp8 instead
(:mod:`.lowp`). It imports nothing of the program.

:func:`follow` runs the first steps of a cell from the weights and
batches the benchmark made, and returns what the check compares: each
step's loss, each leaf's norm of the first clipped gradient, and each
leaf's norm of the parameters' change over the steps.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from . import lowp


def _matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


# rows of a batch whose graph is built at once: each block's graph is
# freed before the next is built, so that no layer is recomputed and the
# reference still fits the card
ROWS_PER_BLOCK = 1


def follow(ref, cfg: Dict, train: Dict, weights: Dict[str, torch.Tensor],
           batches: List[Dict[str, torch.Tensor]], precision: str = "f32"
           ) -> Dict:
    """Train `weights` (dotted path -> tensor in its stored dtype; taken
    over, not copied) on `batches` (one per step, tokens and targets on
    the device) with the hyperparameters in `train`, ``ROWS_PER_BLOCK``
    rows at a time. `ref` is the family's reference module. Returns
    {"loss": [per step], "grad": {path: norm of step 1's clipped
    gradient}, "change": {path: norm of the change}}."""
    mm: Callable = {"f32": _matmul_f32, "fp8": lowp.fp8_matmul}[precision]
    stored = {k: v.dtype for k, v in weights.items()}
    P = {k: v.float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in P.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    b1, b2, eps = train["beta1"], train["beta2"], train["eps"]
    lr, wd, clip = train["lr"], train["weight_decay"], train["grad_clip"]
    out = {"loss": [], "grad": {}, "change": {}}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for step, batch in enumerate(batches, start=1):
            tokens, targets = batch["tokens"], batch["targets"]
            count = targets.numel()
            total = torch.zeros((), dtype=torch.float64, device=tokens.device)
            for r in range(0, tokens.shape[0], ROWS_PER_BLOCK):
                part = ref.loss_sum(P, tokens[r:r + ROWS_PER_BLOCK],
                                    targets[r:r + ROWS_PER_BLOCK], cfg, mm)
                (part / count).backward()
                total += part.detach().double()
            out["loss"].append(float(total / count))
            with torch.no_grad():
                grads = {k: p.grad for k, p in P.items()}
                gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                                       for g in grads.values()))
                scale = min(1.0, clip / (float(gnorm) + 1e-12))
                for k, p in P.items():
                    g = grads[k] * scale
                    if step == 1:
                        out["grad"][k] = float(torch.linalg.vector_norm(g))
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[k] / (1 - b1 ** step)
                    vh = v2[k] / (1 - b2 ** step)
                    new = p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p)
                    p.copy_(new.to(stored[k]).float())
                    p.grad = None
        with torch.no_grad():
            for k, p in P.items():
                out["change"][k] = float(torch.linalg.vector_norm(
                    p - start[k]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out
