"""Training runtime: the data-parallel, tensor-parallel and ZeRO-3 steps,
microbatch accumulation (HDOT subdomains of the global batch),
checkpoint/restart, elastic re-mesh. The port of
``repro/runtime/trainer.py``.

With a DP-only mesh (every non-DP axis of size 1) each rank trains on its
contiguous slice of the global batch, indexed pod-major over the DP axes
(as ``P(("pod", "data"))`` shards it in the JAX package), and the gradient
sum over the DP axes is the explicit schedule from ``core/overlap.py``:
``ParallelConfig.overlap`` picks the HDOT buckets issued during the
backward or the monolithic two-phase baseline, and
``ParallelConfig.grad_buckets`` sets the over-decomposition degree. Without
a mesh the step is the plain accumulation. With
``ParallelConfig.param_shard`` (ZeRO-3) the parameters and the AdamW
moments are this rank's shards of bucket-wise flat buffers
(``core/overlap.py``'s ``FsdpLayout``), gathered and reduce-scattered by
the step (``launch/steps.py``'s ``make_fsdp_train_step``); checkpoints hold
the global flat buffers under the JAX package's keys. On a mesh with a
"model" axis of more than one rank (every family; the MoE blocks under
expert parallelism, each all-to-all in ``moe_a2a_chunks`` slices) each
rank holds its blocks of the parameters and moments under
``rules_for("train")`` (``launch/steps.py``'s ``TPPlan``), every rank of
a model line trains on the same rows (its DP replica's), and checkpoints
hold the global arrays in the replicated layout, so a checkpoint restores
onto any mesh by re-cutting (the elastic path). Parameters and
optimizer state are updated in place on the trainer's device ("cuda"
unless the caller asks for "cpu"). Encoder-decoder and VLM batches carry
the reference's frontend stubs (``_augment_frontend``: constant float32
frames or patches).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.checkpoint.checkpointer import _host
from repro_torch.checkpoint.elastic import unshard_leaf
from repro_torch.config.base import RunConfig
from repro_torch.core.cost import CostModel
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.core.overlap import (_gather, fsdp_group, fsdp_unshard_full,
                                      shard_slice)
from repro_torch.launch.mesh import coords_rank, resolve_device
from repro_torch.launch.steps import (TPPlan, check_ported,
                                      explicit_sync_axes, fsdp_init_state,
                                      make_fsdp_train_step, make_train_step,
                                      make_tp_train_step, tp_size)
from repro_torch.models.layers import (ParamTree, rebuild, tree_leaves,
                                      tree_map)
from repro_torch.models.model import ModelOptions, build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.tracing import span

PyTree = Any


class Trainer:
    def __init__(self, run: RunConfig, mesh=None,
                 options: Optional[ModelOptions] = None,
                 dataset: Optional[SyntheticLMDataset] = None,
                 device="cuda"):
        check_ported(run.parallel, mesh)
        self.run = run
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.opt_cfg = AdamWConfig(
            lr=run.train.lr, beta1=run.train.beta1, beta2=run.train.beta2,
            eps=run.train.eps, weight_decay=run.train.weight_decay,
            grad_clip=run.train.grad_clip)
        self.options = options or ModelOptions(
            attn_impl="dense", scan_layers=run.parallel.scan_layers,
            remat=run.parallel.remat,
            moe_a2a_chunks=run.parallel.moe_a2a_chunks)
        self.model = build_model(run.model, self.options)
        self.data = dataset or SyntheticLMDataset(
            vocab_size=run.model.vocab_size, seq_len=run.train.seq_len,
            global_batch=run.train.global_batch, seed=run.train.seed)
        self.ckpt = AsyncCheckpointer(run.train.checkpoint_dir,
                                      keep=run.train.keep_checkpoints)
        self.rank = mesh.rank if mesh is not None else (
            dist.get_rank() if dist.is_initialized() else 0)
        self.sync_axes, self.explicit = explicit_sync_axes(run.parallel, mesh)
        # tensor parallelism: this rank's blocks of every leaf (the plan
        # creates its process groups here, on every rank in one order)
        self._tp = (TPPlan(self.model, run.parallel, mesh)
                    if tp_size(run.parallel, mesh) > 1 else None)
        self.step = 0
        self.params: Optional[ParamTree] = None
        self.opt_state: Optional[PyTree] = None
        self._step_fn = None
        # ZeRO-3: params/opt live as this rank's shards of bucket-wise flat
        # buffers (see core.overlap.FsdpLayout); None = replicated state
        self._fsdp_layout = None
        # set to a list before the first step to record the ZeRO-3 step's
        # collectives in issue order (core.overlap); None records nothing
        self.fsdp_log: Optional[list] = None
        self.metrics_log: list = []
        # measured-cost model for dynamic re-partitioning: per-step wall
        # clock keyed by this rank. The hook fires every
        # ParallelConfig.rebalance_every steps (0 = never).
        self.cost_model = CostModel()
        self.rebalance_hook: Optional[Callable[[CostModel, int], None]] = None

    # ------------------------------------------------------------------ setup
    def init_state(self, seed: Optional[int] = None,
                   params: Optional[ParamTree] = None) -> None:
        """Fresh parameters from `seed` (default ``run.train.seed``), or
        `params` (e.g. :func:`repro_torch.models.convert.params_from_jax`),
        made trainable; zero optimizer state. Under ZeRO-3 this rank's
        shards (``fsdp_init_state``: drawn bucket by bucket, or cut from
        `params`); on a TP mesh this rank's blocks (``TPPlan.init_state``:
        drawn leaf by leaf, or cut from `params`)."""
        seed = self.run.train.seed if seed is None else seed
        if self._tp is not None:
            self.params, self.opt_state = self._tp.init_state(
                seed, params, self.device)
            self._step_fn = None
            return
        if self.run.parallel.param_shard:
            self.params, self.opt_state, self._fsdp_layout = fsdp_init_state(
                self.model, self.run.parallel, self.mesh, seed, params)
            self._step_fn = None
            return
        if params is None:
            params = self.model.init(seed, self.device)
        params.requires_grad_(True)
        if self._step_fn is not None and self._step_fn.buckets is not None:
            self._step_fn.buckets.remove()     # its hooks sit on old params
        self.params = params
        self.opt_state = adamw_init(params)
        self._step_fn = None

    def full_params(self) -> ParamTree:
        """The parameter tree (replicated: every rank holds all of it).
        Under ZeRO-3 it is reassembled from the flat shards, buffer by
        buffer: a collective, every rank of the DP group must call it (for
        tests and oracles; the step never gathers outside itself). On a TP
        mesh it is all-gathered from the blocks, leaf by leaf (every rank of
        the mesh calls it)."""
        if self._tp is not None:
            return ParamTree(self._unshard(self.params))
        if self._fsdp_layout is None:
            return self.params
        return fsdp_unshard_full(self._global_flat(self.params),
                                 self._fsdp_layout)

    def _unshard(self, blocks: PyTree, host=False) -> PyTree:
        """The full tree of this rank's TP `blocks` (params or a moment),
        gathered leaf by leaf; with `host`, rank 0 copies each leaf to the
        host (numpy, bf16 widened) before the next is gathered and the
        other ranks keep nothing (None)."""
        out = {}
        for i, (path, b) in enumerate(zip(self._tp.paths,
                                          tree_leaves(blocks))):
            full = unshard_leaf(b, self._tp.shardings[i], self.mesh)
            if host:
                full = _host(full) if self.rank == 0 else None
            out[path] = full
        return rebuild(self._tp.spec_tree, out)

    def _global_flat(self, flat: Dict[str, torch.Tensor], host=False
                     ) -> Dict[str, Any]:
        """The global flat buffers of this rank's shards `flat`, gathered
        one buffer at a time in layout order (every rank takes part in each
        gather); with `host`, rank 0 copies each to the host (numpy, bf16
        widened) before the next is gathered, and the other ranks keep
        nothing."""
        group, _ = fsdp_group(self.mesh, self.sync_axes, self._fsdp_layout)
        out = {}
        for key in self._fsdp_layout.keys:
            full = _gather(flat[key], group, self._fsdp_layout.n_shards)[0]
            if not host:
                out[key] = full
            elif self.rank == 0:
                out[key] = _host(full)
        return out

    def _build_step(self) -> Callable:
        run = self.run
        if self._tp is not None:
            return make_tp_train_step(
                self.model, run.parallel, self.mesh, self.opt_cfg,
                warmup_steps=run.train.warmup_steps,
                total_steps=run.train.total_steps, plan=self._tp)
        if run.parallel.param_shard:
            return make_fsdp_train_step(
                self.model, run.parallel, self.mesh, self.opt_cfg,
                warmup_steps=run.train.warmup_steps,
                total_steps=run.train.total_steps,
                layout=self._fsdp_layout, log=self.fsdp_log)
        return make_train_step(self.model, run.parallel, self.opt_cfg,
                               warmup_steps=run.train.warmup_steps,
                               total_steps=run.train.total_steps,
                               mesh=self.mesh, params=self.params)

    # ------------------------------------------------------------------- loop
    def restore_if_available(self) -> bool:
        d = self.run.train.checkpoint_dir
        if latest_step(d) is None:
            return False
        if self.params is None:
            self.init_state()
        target = {"params": self.params, "opt": self.opt_state}
        if self._fsdp_layout is not None:
            # ZeRO-3: the checkpoint holds the global flat buffers; params
            # AND moments go back to this rank's shards
            _, index = fsdp_group(self.mesh, self.sync_axes,
                                  self._fsdp_layout)
            cpu = {k: torch.empty(0, dtype=v.dtype)
                   for k, v in self.params.items()}
            _, tree, extra = restore_checkpoint(d, {
                "params": cpu,
                "opt": {"m": {k: torch.empty(0) for k in cpu},
                        "v": {k: torch.empty(0) for k in cpu},
                        "step": torch.empty(0, dtype=torch.int32)}})
            tree = tree_map(lambda t: t if t.dim() == 0 else shard_slice(
                t, self._fsdp_layout.n_shards, index), tree)
        elif self._tp is not None:
            # the checkpoint holds global arrays: read them on the host
            # and cut this rank's blocks of params AND moments (the
            # elastic path: the mesh it was written on does not matter)
            cpu = rebuild(self._tp.spec_tree, {
                p: torch.empty(0, dtype=s.dtype)
                for p, s in zip(self._tp.paths, self._tp.specs)})
            f32 = tree_map(lambda _: torch.empty(0), cpu)
            _, tree, extra = restore_checkpoint(d, {
                "params": cpu, "opt": {
                    "m": f32, "v": f32,
                    "step": torch.empty(0, dtype=torch.int32)}})

            def blocks(full):
                return [self._tp.block(i, t)
                        for i, t in enumerate(tree_leaves(full))]
            tree = {"params": blocks(tree["params"]),
                    "opt": {"m": blocks(tree["opt"]["m"]),
                            "v": blocks(tree["opt"]["v"]),
                            "step": tree["opt"]["step"]}}
        else:
            _, tree, extra = restore_checkpoint(d, target)
        # copy into the live tensors: the step's gradient hooks sit on them
        with torch.no_grad():
            for dst, src in zip(tree_leaves(target), tree_leaves(tree)):
                dst.copy_(src)
        self.step = int(extra.get("data_step", 0))
        return True

    def save(self) -> None:
        """Write a checkpoint (rank 0 only: the replicas hold the same
        state). Under ZeRO-3 the global flat buffers of params and moments,
        under the JAX package's keys, gathered buffer by buffer to the
        host (every rank takes part in each gather; rank 0 writes)."""
        tree = {"params": self.params, "opt": self.opt_state}
        if self._tp is not None:
            tree = {"params": self._unshard(self.params, host=True),
                    "opt": {"m": self._unshard(self.opt_state["m"], True),
                            "v": self._unshard(self.opt_state["v"], True),
                            "step": self.opt_state["step"]}}
        elif self._fsdp_layout is not None:
            tree = {"params": self._global_flat(self.params, host=True),
                    "opt": {"m": self._global_flat(self.opt_state["m"], True),
                            "v": self._global_flat(self.opt_state["v"], True),
                            "step": self.opt_state["step"]}}
        if self.rank != 0:
            return
        self.ckpt.save(self.step, tree,
                       extra={"data_step": self.step,
                              "data": self.data.state(self.step)})

    def _augment_frontend(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
        """The modality-frontend STUBS of the reference: encoder-decoder and
        VLM batches carry precomputed frame or patch embeddings, here the
        constant 0.02 in float32, as the reference builds them (so the
        encoder runs in float32, ``ROADMAP.md`` Queue 3)."""
        cfg = self.run.model
        b = batch["tokens"].shape[0]
        if cfg.family == "encdec" and "frames" not in batch:
            batch = dict(batch, frames=np.full(
                (b, cfg.encdec.enc_seq, cfg.d_model), 0.02, np.float32))
        if cfg.family == "vlm" and "patches" not in batch:
            batch = dict(batch, patches=np.full(
                (b, cfg.num_vision_patches, cfg.d_model), 0.02, np.float32))
        return batch

    def _place_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This rank's rows of step `step`'s global batch, with the
        frontend stubs, on the device (token ids as int64): the whole
        batch without an explicit mesh, else the contiguous slice of DP
        index pod-major over the sync axes. On a TP mesh (the same rows on
        every rank of a "model" line) the microbatches are the global
        batch's, as GSPMD splits them: the rank takes its DP block of each
        of the ``accum_steps`` microbatches in turn (with one microbatch,
        the contiguous slice), so that a MoE aux loss, which averages its
        expert loads over the ranks, averages the same rows as the
        reference's."""
        if self._tp is not None:
            accum = self.run.parallel.accum_steps
            dp, idx = self._tp.dp, self._tp.dp_index
            batch = {k: v.reshape(accum, dp, -1, *v.shape[1:])[:, idx]
                     .reshape(-1, *v.shape[1:])
                     for k, v in self.data.batch_at(step).items()}
        elif self.explicit:
            sizes = [self.mesh.shape[a] for a in self.sync_axes]
            coords = [self.mesh.coords[self.mesh.axis_index(a)]
                      for a in self.sync_axes]
            batch = self.data.host_slice(step, coords_rank(coords, sizes),
                                         int(np.prod(sizes)))
        else:
            batch = self.data.batch_at(step)
        batch = self._augment_frontend(batch)
        return {k: torch.from_numpy(v).to(
                    self.device, torch.int64 if v.dtype.kind in "iu" else None)
                for k, v in batch.items()}

    def train(self, num_steps: int,
              failure_hook: Optional[Callable[[int], None]] = None) -> Dict:
        """Run `num_steps` steps from the current position. `failure_hook`
        lets tests inject faults (raises) at chosen steps. A step's body
        is four spans end to end (``runtime/tracing.py``):
        ``trainer.place_batch``, ``trainer.step`` (the step number its
        argument), ``trainer.readback`` (the metrics' ``float()``) and
        ``trainer.log`` (the cost model, the rebalance hook, the
        checkpoint and the log)."""
        if self.params is None:
            if not self.restore_if_available():
                self.init_state()
        if self._step_fn is None:
            self._step_fn = self._build_step()
        t0 = time.time()
        rebalance_every = self.run.parallel.rebalance_every
        for _ in range(num_steps):
            with span("trainer.place_batch"):
                if failure_hook is not None:
                    failure_hook(self.step)
                batch = self._place_batch(self.step)
            with span("trainer.step", str(self.step)):
                ts = time.perf_counter()
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
            # float() waits for the step's outputs, so the measured span is
            # the step's compute, not its launches
            with span("trainer.readback"):
                metrics = {k: float(v) for k, v in metrics.items()}
            with span("trainer.log"):
                self.cost_model.record((self.rank,),
                                       time.perf_counter() - ts,
                                       cells=self.run.train.global_batch)
                self.step += 1
                if (rebalance_every and self.rebalance_hook is not None
                        and self.step % rebalance_every == 0):
                    self.rebalance_hook(self.cost_model, self.step)
                if self.step % self.run.train.checkpoint_every == 0:
                    self.save()
                self.metrics_log.append(metrics | {"step": self.step})
        self.ckpt.wait()
        return {"steps": num_steps, "seconds": time.time() - t0,
                "final": self.metrics_log[-1] if self.metrics_log else {}}
