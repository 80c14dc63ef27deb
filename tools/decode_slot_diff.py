"""Find the first operation of a decode step whose output for one request
depends on how many slots run beside it.

    PYTHONPATH=src python3 tools/decode_slot_diff.py --arch mamba2-780m
    PYTHONPATH=src python3 tools/decode_slot_diff.py --arch qwen3-moe-30b-a3b

Builds the model at its published widths in bf16 (random weights from seed
0; ``--reduced`` for the reduced config), admits 8 prompts (numpy seed 0,
lengths uniform in 128-512) into an 8-slot cache and prompt 0 alone into a
1-slot cache, then runs one decode step of each with the same token in slot
0, under a ``TorchDispatchMode`` that keeps every aten operation's
outputs. The two steps' operations are aligned by name and calling frame;
each 8-slot output is cut to slot 0 (the dim where it has 8 and the 1-slot
output 1) and compared bit for bit with the 1-slot one (operations that
reduce over the slots, the aux loss's means, are skipped). Prints one JSON line: the first operation that differs
(its aten name, input and output shapes, the largest difference, and the
innermost frame of ``repro_torch`` that called it), the number of
operations compared and of those that differ, and the card's name and
power limit. Needs a CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _tensors(out):
    return [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]


def _results(out, args):
    """The op's outputs that are new tensors (a view of an input, such as a
    transposed weight, is None: it holds nothing the op computed)."""
    held = {t.untyped_storage().data_ptr() for t in _tensors(args)}
    return [None if t.untyped_storage().data_ptr() in held else t
            for t in _tensors(out)]


def _caller() -> str:
    for fr in reversed(traceback.extract_stack()[:-3]):
        if "repro_torch" in fr.filename:
            return f"{fr.filename.split('src/')[-1]}:{fr.lineno} {fr.name}"
    return "?"


def _slot0(t: torch.Tensor, like: torch.Tensor):
    """`t` (an 8-slot output) cut to slot 0 along the dim where `like` (the
    1-slot output) has 1 and `t` has 8; `t` itself where the shapes agree;
    None where they cannot be matched."""
    if t.shape == like.shape:
        return t
    if t.dim() != like.dim():
        return None
    dims = [i for i, (a, b) in enumerate(zip(t.shape, like.shape)) if a != b]
    if len(dims) != 1 or like.shape[dims[0]] != 1:
        return None
    return t.narrow(dims[0], 0, 1)


class _Record(TorchDispatchMode):
    """Keeps every operation's name, input shapes, new outputs and the
    frame of the port that called it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors(args)
        self.ops.append({
            "op": str(func), "inputs": [list(t.shape) for t in ins],
            "in_ptrs": {t.untyped_storage().data_ptr() for t in ins},
            "out_ptrs": {t.untyped_storage().data_ptr()
                         for t in _tensors(out)},
            "out": [None if t is None else t.clone()
                    for t in _results(out, args)],
            "caller": _caller()})
        return out


def first_difference(one, eight):
    """Aligns the two steps' operation sequences (by name and caller) and
    compares each matched operation's slot-0 outputs. An operation whose
    inputs differ in shape but whose outputs do not reduced over the slots
    (the aux loss's means): it, and whatever is computed from it, is
    skipped. Returns (first differing operation or None, outputs compared,
    outputs that differ)."""
    import difflib

    key = [(o["op"], o["caller"]) for o in one]
    key8 = [(o["op"], o["caller"]) for o in eight]
    sm = difflib.SequenceMatcher(None, key, key8, autojunk=False)
    pair = {}
    for block in sm.get_matching_blocks():
        for j in range(block.size):
            pair[block.b + j] = block.a + j
    first, compared, differ, tainted = None, 0, 0, set()
    for i, b in enumerate(eight):
        a = one[pair[i]] if i in pair else None
        real = [] if a is None else [(w, g) for w, g in zip(a["out"],
                                                             b["out"])
                                     if w is not None and g is not None]
        aggregate = (a is not None and a["inputs"] != b["inputs"] and real
                     and all(w.shape == g.shape for w, g in real))
        if aggregate or b["in_ptrs"] & tainted:
            tainted |= b["out_ptrs"]
            continue
        tainted -= b["out_ptrs"]           # fresh results at these ptrs
        if a is None or len(a["out"]) != len(b["out"]):
            continue
        for w, g in zip(a["out"], b["out"]):
            cut = None if w is None or g is None else _slot0(g, w)
            if cut is None:
                continue
            compared += 1
            if torch.equal(cut, w):
                continue
            differ += 1
            if first is None:
                diff = (cut.double() - w.double()).abs()
                first = {"index": i, "op": b["op"], "inputs": b["inputs"],
                         "output": list(g.shape), "dtype": str(g.dtype),
                         "max_abs_diff": float(diff.max()),
                         "caller": b["caller"]}
    return first, compared, differ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import resolve_device
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import (_mark_prefill_tail,
                                            _scatter_slot, make_slot_caches)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.bfloat16))
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in rng.integers(128, 513, 8)]
    max_len = 520
    steps = {}
    for slots in (1, 8):
        caches = make_slot_caches(model, slots, max_len, dev)
        for i, pr in enumerate(prompts[:slots]):
            _, pc = model.prefill(params, {"tokens": torch.tensor(
                [pr], device=dev)}, max_len=max_len)
            _scatter_slot(caches, _mark_prefill_tail(pc, len(pr)), i, slots)
        tok = torch.tensor([[7]] * slots, device=dev)
        pos = torch.tensor([len(p) for p in prompts[:slots]], device=dev)
        steps[slots] = (tok, caches, pos)
    with _Record() as rec:
        one, _ = model.decode_step(params, *steps[1])
    with _Record() as rec8:
        eight, _ = model.decode_step(params, *steps[8])
    first, compared, differ = first_difference(rec.ops, rec8.ops)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "arch": cfg.name, "ops_1_slot": len(rec.ops),
        "ops_8_slots": len(rec8.ops), "outputs_compared": compared,
        "outputs_differ": differ, "first_difference": first,
        "logits_bit_identical": bool(torch.equal(eight[:1], one)),
        "logits_max_abs_diff": float((eight[:1] - one).abs().max()),
        "gpu": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
