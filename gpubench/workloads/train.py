"""How a training mix (``"kind": "train"``) is run, on one chip.

Set-up builds one :class:`~repro_torch.runtime.trainer.Trainer`, hands it
the weights the benchmark drew from the seed and the benchmark's own
token stream (the trainer reads it through ``batch_at``), and drives it
through its first steps with ``Trainer.train`` - the window's own call
and feed. These steps build the kernels, warm every shape and give the
readings the check compares: each step's loss, each leaf's norm of the
first clipped gradient (from the AdamW first moment after one step:
m = (1 - beta1) g) and each leaf's norm of the parameters' change over
the steps. The same trainer then runs the measured window (``--trace
0``) or the traced steps (``--trace 1``), one ``train(1)`` call a step,
each ending in the trainer's read-back of the step's metrics. After the
window the program's state is freed and the plain reference follows the
same steps from the same weights and batches.

No checkpoint is written: ``checkpoint_every`` lies beyond every step a
run makes, and the directory it names is under ``TMPDIR``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from gpubench import bench, check, weights as wts
from gpubench.data import TokenStream
from gpubench.reference import train as ref_train

GIB = 2 ** 30


def model_config(cfg: Dict):
    """The program's ModelConfig of a configuration file: its top-level
    fields, and each nested group as the dataclass of that name."""
    from repro_torch.config import base

    groups = {"ssm": base.SSMConfig, "moe": base.MoEConfig,
              "hybrid": base.HybridConfig, "encdec": base.EncDecConfig}
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    for key, cls in groups.items():
        if cfg.get(key) is not None:
            kw[key] = cls(**cfg[key])
    return base.ModelConfig(**kw)


def run_config(cfg: Dict, traffic: Dict, seed: int):
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig

    t = traffic["train"]
    return RunConfig(
        model=model_config(cfg),
        parallel=ParallelConfig(**traffic.get("parallel", {})),
        train=TrainConfig(
            global_batch=traffic["batch"], seq_len=traffic["seq_len"],
            lr=t["lr"], warmup_steps=0, total_steps=10 ** 9,
            weight_decay=t["weight_decay"], beta1=t["beta1"],
            beta2=t["beta2"], eps=t["eps"], grad_clip=t["grad_clip"],
            seed=seed % 2 ** 31, checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(tempfile.gettempdir(),
                                        "gpubench_no_checkpoint")))


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted paths of a nested tree of dicts, lists and nn.Modules."""
    if isinstance(tree, torch.nn.Module) and not isinstance(
            tree, torch.nn.ModuleList):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0
           ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) * scale
            for k, v in tree.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start(cell: Dict, seed: int, device: str,
          patch: Optional[Callable] = None):
    """Set-up: the trainer with the drawn weights, driven through the
    followed steps. Returns (trainer, the program's readings)."""
    from repro_torch.models.layers import ParamTree
    from repro_torch.runtime.trainer import Trainer

    cfg, traffic = cell["config"], cell["traffic"]
    ref = importlib.import_module(f"gpubench.reference.{cfg['family']}")
    stream = TokenStream.from_traffic(traffic, cfg["vocab_size"], seed)
    follow = traffic["follow_steps"]
    trainer = Trainer(run_config(cfg, traffic, seed), dataset=stream,
                      device=device)
    first = wts.draw(ref.param_table(cfg), seed, device)
    trainer.init_state(params=ParamTree(nest(
        {k: v.clone() for k, v in first.items()})))
    if patch is not None:
        patch(trainer)
    trainer.train(1)
    grad = _norms(flatten(trainer.opt_state["m"]),
                  1.0 / (1.0 - traffic["train"]["beta1"]))
    trainer.train(follow - 1)
    params = flatten(trainer.params)
    change = {k: float(torch.linalg.vector_norm(
        params[k].detach().float() - first[k].float())) for k in first}
    program = {"loss": [m["loss"] for m in trainer.metrics_log[:follow]],
               "grad": grad, "change": change}
    return trainer, program


def reference(cell: Dict, seed: int, device: str, precision: str = "f32"
              ) -> Dict:
    """The plain reference (or, with precision "fp8", the control)
    through the followed steps, from the same weights and batches."""
    cfg, traffic = cell["config"], cell["traffic"]
    ref = importlib.import_module(f"gpubench.reference.{cfg['family']}")
    stream = TokenStream.from_traffic(traffic, cfg["vocab_size"], seed)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in stream.batch_at(step).items()}
               for step in range(traffic["follow_steps"])]
    return ref_train.follow(ref, cfg, traffic["train"],
                            wts.draw(ref.param_table(cfg), seed, device),
                            batches, precision)


def free(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, patch: Optional[Callable] = None,
        counters: Sequence[str] = ()) -> Dict:
    """One run of a training cell. `t_start` is the process's start on the
    host clock (set-up counts from it); `patch`, for tests, is applied to
    the trainer before its first step (a fault planted in the timed
    path); `counters` are the program's counters the traced steps' trace
    carries (``bench.counter``). Returns the result line's fields and the
    check's readings."""
    traffic = cell["traffic"]
    trainer, program = start(cell, seed, device, patch)
    free(device)
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    out: Dict = {"program": program}
    if trace:
        out.update(_traced(trainer, traffic["trace_steps"], device,
                           t_start, counters))
    else:
        out.update(_window(trainer, seconds,
                           traffic["batch"] * traffic["seq_len"], t_start))
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out["train_peak_gib"] = window_peak / GIB
    out["memory_peak_bytes"] = max(setup_peak, window_peak)
    del trainer
    free(device)
    t0 = time.perf_counter()
    out["checks"] = check.compare(program, reference(cell, seed, device),
                                  cell["limits"])
    out["reference_s"] = time.perf_counter() - t0
    return out


def _window(trainer, seconds: float, tokens_per_step: int,
            t_start: float) -> Dict:
    steps, failed, times = 0, 0, []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        trainer.train(1)
        times.append(time.perf_counter() - ts)
        steps += 1
        if not math.isfinite(trainer.metrics_log[-1]["loss"]):
            failed += 1
    elapsed = time.perf_counter() - t0
    return {"setup_s": setup_s, "attempted": steps, "failed": failed,
            "train_tokens_per_s": steps * tokens_per_step / elapsed,
            "window_s": elapsed, "step_s": times}


def _traced(trainer, steps: int, device, t_start: float,
            counters: Sequence[str]) -> Dict:
    from gpubench import trace as tr

    setup_s = time.perf_counter() - t_start
    before = {c: bench.counter(c) for c in counters}

    def body() -> int:
        for _ in range(steps):
            with torch.profiler.record_function("gpubench_step"):
                trainer.train(1)
        return steps

    t = tr.capture(body, lambda: _sync(device))
    t.counters = {c: bench.counter(c) - v for c, v in before.items()}
    failed = sum(not math.isfinite(m["loss"])
                 for m in trainer.metrics_log[-steps:])
    return {"setup_s": setup_s, "attempted": steps, "failed": failed,
            "trace": t}

