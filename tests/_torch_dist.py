"""Multi-rank runs of the port for the tests. Imports no jax.

:func:`spawn` starts one process per rank, each running this file:

    python tests/_torch_dist.py <workdir> <rank> <world>

A rank reads ``<workdir>/job.json`` (the mesh, the backend and what to run)
and ``<workdir>/u0.npy`` (the global grid), joins the process group through
the FileStore ``<workdir>/store``, runs the job and writes the gathered
global results and its message counts to ``<workdir>/rank<r>.npz``. With
``"backend": "gloo"`` the ranks run on the CPU with one thread each; with
``"nccl"`` rank r runs on CUDA device r.

A job runs Heat2D when it names ``iters``, and any of the other
applications it names (``rk3``, ``hpccg``, ``allreduce``, ``moe``, the TP
rings ``tp_ring`` and the TP decode step ``tp_decode``), each on a mesh of
its own over the same ranks; their inputs are made here from a numpy seed
(:func:`app_input`, :func:`moe_input`, :func:`ring_input`) or the port's
init (:func:`tp_model`), so the parent makes the same ones. The rings'
point-to-point sends are counted (``_SendLog.sends``). A job naming
``gradsync`` sums an integer-valued mixed-dtype tree (:func:`sync_tree`)
under both schedules; one naming ``train`` trains the reduced model under
each (overlap, accum_steps) case it lists, starting from the checkpoint
the parent wrote to ``<workdir>/init``, with every ``dist.all_reduce``
logged (:func:`run_train`); one naming ``zero3`` trains it under ZeRO-3,
gathering all and streaming, with the collectives' issue order logged
(:func:`run_zero3`), and one naming ``zero3_full`` trains a model at its
published widths under streaming ZeRO-3, timed (:func:`run_zero3_full`);
one naming ``tp_full`` serves a model at its published widths through the
TP decode step, timed and traced (:func:`run_tp_full`). One naming
``tp_train`` trains the reduced dense models tensor-parallel on a
("data", "model") or ("pod", "data", "model") mesh from checkpoints the
parent wrote (:func:`run_tp_train`), one naming ``tp_elastic`` restores a
TP trainer's checkpoint onto other meshes and trains on
(:func:`run_tp_elastic`), and one naming ``tp_train_full`` trains a model
at its published widths tensor-parallel, timed and traced
(:func:`run_tp_train_full`). One naming ``tp_units`` runs the TP cut's
building blocks against the same math on one rank (:func:`run_tp_units`).
Ones naming ``serve_cells``, ``flash_decode`` or ``serve_full`` run the
serving cells (``tests/_torch_serve.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import halo
from repro_torch.core import reduction
from repro_torch.core.overlap import grad_sync
from repro_torch.core.stencil import (_trailing_dims, gather_global,
                                      heat2d_solve, hpccg_solve, local_block,
                                      rk3_solve)
from repro_torch.kernels.heat2d.ops import heat2d_sweep_sharded
from repro_torch.launch.mesh import make_mesh, rank_coords
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.compression import make_crosspod_codec

REPO = Path(__file__).resolve().parents[1]


def _star(p):
    """5-point Jacobi on a block padded by 1 on both dims (the 2-D stencil
    of the scan job)."""
    return 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def _sum3(p):
    """width-1 smoothing along dim 0 (the 1-D stencil of the scan job):
    additions, then one multiplication, so no backend can fuse an FMA."""
    return 0.25 * (p[:-2] + p[1:-1] + p[2:])


class _SendLog:
    """Counts ``batch_isend_irecv`` calls per mesh axis (one call is one
    exchange of one axis, or one hop of a collective-matmul ring) and the
    point-to-point sends they carry (``sends``)."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.sends = mesh, [], 0
        self._orig = dist.batch_isend_irecv

    def __call__(self, ops):
        me = self.mesh.coords
        peer = rank_coords(ops[0].peer, self.mesh.sizes)
        axis = [k for k, (a, b) in enumerate(zip(me, peer)) if a != b]
        self.calls.append(axis[0])
        self.sends += sum(op.op is dist.isend for op in ops)
        return self._orig(ops)

    def per_axis(self):
        return np.bincount(np.asarray(self.calls, np.int64),
                           minlength=len(self.mesh.sizes))


class _ReduceLog:
    """Counts ``dist.all_reduce`` calls per mesh axis (by the axis's line
    group)."""

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, []
        self._orig = dist.all_reduce

    def __call__(self, t, *args, group=None, **kw):
        names = [a for a in self.mesh.axis_names
                 if self.mesh.groups[a] is group]
        self.calls.append(self.mesh.axis_index(names[0]))
        return self._orig(t, *args, group=group, **kw)

    def per_axis(self):
        return np.bincount(np.asarray(self.calls, np.int64),
                           minlength=len(self.mesh.sizes))


def _logged_sends(mesh, fn):
    """(fn(), the point-to-point sends it made)."""
    log = _SendLog(mesh)
    dist.batch_isend_irecv = log
    try:
        return fn(), log.sends
    finally:
        dist.batch_isend_irecv = log._orig


def app_input(spec: dict, rank: int = 0) -> np.ndarray:
    """The input of an application job: standard normal f32 of
    ``spec["shape"]`` from numpy seed ``spec["seed"]`` (+ the rank, for the
    all-reduce, whose ranks each hold their own)."""
    seed = spec["seed"] + (rank if spec.get("per_rank") else 0)
    return np.random.default_rng(seed).standard_normal(
        tuple(spec["shape"])).astype(np.float32)


def _counted(mesh, fn):
    """Run `fn()` with the exchanges and all-reduces counted per axis."""
    sends, reduces = _SendLog(mesh), _ReduceLog(mesh)
    dist.batch_isend_irecv, dist.all_reduce = sends, reduces
    try:
        out = fn()
    finally:
        dist.batch_isend_irecv, dist.all_reduce = sends._orig, reduces._orig
    return out, sends.per_axis(), reduces.per_axis()


def run_apps(job, device):
    out = {}
    for app in ("rk3", "hpccg"):
        if app not in job:
            continue
        spec = job[app]
        axes = tuple(spec["axes"])
        mesh = make_mesh(tuple(spec["mesh"]), axes, device)
        g = app_input(spec)
        for mode in ("two_phase", "hdot"):
            if app == "rk3":
                (x, hist), sends, reduces = _counted(mesh, lambda: (
                    rk3_solve(torch.from_numpy(g), mesh, axes, spec["steps"],
                              spec["dt"], mode), None))
            else:
                (x, hist), sends, reduces = _counted(mesh, lambda: hpccg_solve(
                    torch.from_numpy(g), mesh, axes, spec["iters"], mode))
                out[f"hpccg_hist_{mode}"] = hist.cpu().numpy()
            out[f"{app}_{mode}"] = gather_global(
                x, mesh, axes, g.shape, _trailing_dims(axes)).cpu().numpy()
            out[f"{app}_sends_{mode}"] = sends
            out[f"{app}_reduces_{mode}"] = reduces
    if "allreduce" in job:
        spec = job["allreduce"]
        mesh = make_mesh(tuple(spec["mesh"]), ("pod", "data"), device)
        x = torch.from_numpy(app_input(spec, mesh.rank)).to(device)
        odd = x[:spec["odd_rows"]].contiguous()   # does not tile over data
        comp, decomp = make_crosspod_codec(mesh, "pod")
        out["ar_staged"] = reduction.hierarchical_allreduce(
            x, mesh, "data", "pod").cpu().numpy()
        out["ar_comp"] = reduction.hierarchical_allreduce(
            x, mesh, "data", "pod", 0, comp, decomp).cpu().numpy()
        out["ar_plain"] = reduction.process_allreduce(
            x, mesh, ("pod", "data")).cpu().numpy()
        out["ar_odd"] = reduction.hierarchical_allreduce(
            odd, mesh, "data", "pod").cpu().numpy()
        out["ar_odd_plain"] = reduction.process_allreduce(
            odd, mesh, ("data", "pod")).cpu().numpy()  # the fallback's order
        q = torch.from_numpy(np.random.default_rng(mesh.rank).integers(
            -127, 128, (33,)).astype(np.int16)).to(device)
        out["int16_sum"] = reduction._sum_payload(q, mesh, "pod").cpu(
            ).numpy()
    if "moe" in job:
        out.update(run_moe(job["moe"], device))
    if "tp_ring" in job:
        out.update(run_tp_ring(job["tp_ring"], device))
    if "tp_decode" in job:
        out.update(run_tp_decode(job["tp_decode"], device))
    return out


def moe_config(spec):
    """The reduced Qwen3-MoE config with the job's experts, top-k and
    capacity factor."""
    import dataclasses

    from repro_torch.config.registry import get_arch

    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=spec["experts"], top_k=spec["top_k"],
        capacity_factor=spec["factor"]))


def moe_input(spec):
    """(params, x, x_decode) of the MoE job as float32 numpy arrays: the
    block's leaves normal / sqrt(fan_in), x (B, S, d) and the decode input
    (B_decode, 1, d) normal times 0.3, from numpy seed ``spec["seed"]``."""
    d, E, f = 128, spec["experts"], 64
    rng = np.random.default_rng(spec["seed"])

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    p = {"router": draw(d, E), "gate": draw(E, d, f), "up": draw(E, d, f),
         "down": draw(E, f, d)}
    x = (rng.standard_normal((spec["batch"], spec["seq"], d)) * 0.3).astype(
        np.float32)
    xd = (rng.standard_normal((spec["decode_batch"], 1, d)) * 0.3).astype(
        np.float32)
    return p, x, xd


def run_moe(spec, device):
    """Expert parallelism over the job's mesh: each rank takes its
    data-parallel replica's rows of x (all of them without a "data"
    axis), for each Q of ``spec["chunks"]`` runs moe_apply_ep with fresh
    parameters, and back-propagates its share of the global loss
    sum(y^2) + aux (the global loss is the sum of the ranks' losses: y is
    the same on the n ranks of a "model" line, aux on every rank). It
    saves y, the global loss, the parameter gradients summed over all
    ranks (each rank holds every expert and fills its own experts' rows)
    and the a2a_scan issue log of the forward; then the decode step
    through moe_apply (the batch in the token slot)."""
    from repro_torch.models import moe

    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    cfg = moe_config(spec)
    p_np, x_np, xd_np = moe_input(spec)
    n_data = mesh.shape.get("data", 1)
    d = mesh.coords[mesh.axis_index("data")] if n_data > 1 else 0
    rows = x_np.shape[0] // n_data
    x = torch.from_numpy(x_np[d * rows:(d + 1) * rows]).to(device)
    world = mesh.size
    out = {}
    for q in spec["chunks"]:
        p = {k: torch.from_numpy(v).to(device).requires_grad_()
             for k, v in p_np.items()}
        log = []
        y, aux = moe.moe_apply_ep(moe.expert_block(p, mesh), x, cfg, mesh,
                                  a2a_chunks=q, log=log)
        loss = (y * y).sum() / mesh.shape["model"] + aux / world
        fwd = list(log)     # the forward's schedule; the backward's follows
        loss.backward()
        total = loss.detach().clone()
        dist.all_reduce(total)
        out[f"moe_y_q{q}"] = y.detach().cpu().numpy()
        out[f"moe_loss_q{q}"] = total.cpu().numpy()
        for k, v in p.items():
            g = v.grad.clone()
            dist.all_reduce(g)
            out[f"moe_grad_{k}_q{q}"] = g.cpu().numpy()
        out[f"moe_log_q{q}"] = np.array([f"{w}{k}" for w, k in fwd])
    rows = xd_np.shape[0] // n_data
    xd = torch.from_numpy(xd_np[d * rows:(d + 1) * rows]).to(device)
    p = {k: torch.from_numpy(v).to(device) for k, v in p_np.items()}
    out["moe_route_decode"] = np.array(moe.ep_route(mesh, cfg.moe.num_experts,
                                                    xd.shape))
    out["moe_y_decode"] = moe.moe_apply(p, xd, cfg, mesh)[0].cpu().numpy()
    out["moe_data_coord"] = np.array(d)
    out.update(run_moe_model(spec, mesh, d, device))
    return out


def moe_model_tokens(spec):
    """The MoE model job's tokens: (batch, seq + 1) from numpy seed
    ``spec["seed"]`` + 1 (the last column is the decode step's token)."""
    return np.random.default_rng(spec["seed"] + 1).integers(
        1, 256, (spec["model_batch"], spec["seq"] + 1))


def run_moe_model(spec, mesh, d, device):
    """The reduced model (the job's MoE config, float32, flash attention)
    with ``ModelOptions(mesh=mesh)``, so its MoE blocks take expert
    parallelism: this data replica's rows prefilled, then one decode
    step; the last-token logits of each, and the all-to-alls sent."""
    from repro_torch.models.model import ModelOptions, build_model

    cfg = moe_config(spec)
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.float32, mesh=mesh))
    params = model.init(0, "cpu").to(device)
    toks = moe_model_tokens(spec)
    rows = toks.shape[0] // mesh.shape.get("data", 1)
    toks = torch.from_numpy(toks[d * rows:(d + 1) * rows]).to(device)
    s = spec["seq"]
    calls, orig = [], dist.all_to_all_single
    dist.all_to_all_single = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        logits, caches = model.prefill(params, {"tokens": toks[:, :s]},
                                       max_len=s + 1)
        step, _ = model.decode_step(params, toks[:, s:], caches, s)
    finally:
        dist.all_to_all_single = orig
    return {"moe_model_prefill": logits.cpu().numpy(),
            "moe_model_decode": step.cpu().numpy(),
            "moe_model_a2a_calls": np.array(len(calls))}


# the ring job's cases, (mode, chunks): the JAX suite's (tests/test_system.py)
RING_CASES = (("two_phase", None), ("hdot", None), ("hdot", 1), ("hdot", 3))


def ring_input(spec, n: int):
    """(x, w, h, v) of the ring job on `n` ranks, standard normal float32
    from numpy seed ``spec["seed"] + n``: x (rows·n, m) and w (m, cols·n)
    for ag_matmul, h (rows·n, cols·n) and v (cols·n, m) for matmul_rs.
    Rank r holds x's rows, w's and h's columns and v's rows of block r."""
    rng = np.random.default_rng(spec["seed"] + n)
    rows, cols, m = spec["rows"] * n, spec["cols"] * n, spec["m"]

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return draw(rows, m), draw(m, cols), draw(rows, cols), draw(cols, m)


def run_tp_ring(spec, device):
    """ag_matmul and matmul_rs of every RING_CASES case on the job's
    ("model",) ring: this rank's output and the sends of each call."""
    from repro_torch.core import collective_matmul as cm

    mesh = make_mesh(tuple(spec["mesh"]), ("model",), device)
    r = mesh.rank
    x, w, h, v = ring_input(spec, mesh.size)
    rb = slice(r * spec["rows"], (r + 1) * spec["rows"])
    cb = slice(r * spec["cols"], (r + 1) * spec["cols"])
    args = {"ag": (cm.ag_matmul, x[rb], w[:, cb]),
            "rs": (cm.matmul_rs, h[:, cb], v[cb])}
    out = {}
    for mode, chunks in RING_CASES:
        for name, (fn, a, b) in args.items():
            y, sends = _logged_sends(mesh, lambda: fn(
                torch.from_numpy(a).to(device), torch.from_numpy(b).to(device),
                mesh, "model", mode, chunks))
            out[f"ring_{name}_{mode}_{chunks}"] = y.cpu().numpy()
            out[f"ring_{name}_{mode}_{chunks}_sends"] = np.array(sends)
    return out


# the TP decode job's traffic: tests/test_decode_tp.py's (6 requests through
# 4 slots, with refills)
TP_PROMPTS = [[5, 9, 3], [7, 1], [2, 2, 2, 2, 8], [11], [4, 6], [1, 2, 3]]
TP_MAX_NEW = [4, 6, 2, 1, 5, 3]


def tp_fields(spec) -> dict:
    """The TP decode job's changes to the reduced qwen3-8b config:
    ``spec["layers"]`` layers and ``spec["heads"]`` (query, KV) heads (the
    reduced config's 2 KV heads do not divide over 4 ranks)."""
    return dict(num_layers=spec["layers"], num_heads=spec["heads"][0],
                num_kv_heads=spec["heads"][1])


def tp_model(spec, device):
    """(model, params) of the TP decode job: reduced qwen3-8b changed by
    :func:`tp_fields`, float32, dense attention, scanned, the port's init
    from ``spec["seed"]`` drawn on the CPU (its CRC-32 leaf seeds give
    every process the same tree)."""
    import dataclasses

    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions, build_model

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              **tp_fields(spec))
    model = build_model(cfg, ModelOptions(attn_impl="dense",
                                          dtype=torch.float32))
    return model, model.init(spec["seed"], "cpu").to(device)


def tp_admitted(model, params, spec, device):
    """(token, caches, pos) of one teacher-forced decode step: the first
    `slots` prompts admitted into a `slots`-slot server's caches (batch-1
    prefills, as the server admits), token 7 + i in slot i."""
    from repro_torch.runtime.server import (_mark_prefill_tail,
                                            _scatter_slot, make_slot_caches)

    slots, max_len = spec["slots"], spec["max_len"]
    caches = make_slot_caches(model, slots, max_len, device)
    for i, p in enumerate(TP_PROMPTS[:slots]):
        _, pc = model.prefill(params, {"tokens": torch.tensor([p],
                                                              device=device)},
                              max_len=max_len)
        _scatter_slot(caches, _mark_prefill_tail(pc, len(p)), i, slots)
    token = torch.tensor([[7 + i] for i in range(slots)], device=device)
    pos = torch.tensor([len(p) for p in TP_PROMPTS[:slots]], device=device)
    return token, caches, pos


def tp_serve(model, params, spec, decode_step_fn=None):
    """The job's requests through run_continuous: (outputs by request id,
    -1 past a request's end, as one array; the server's stats)."""
    from repro_torch.runtime.server import BatchServer, Request

    srv = BatchServer(model, params, slots=spec["slots"],
                      max_len=spec["max_len"], decode_step_fn=decode_step_fn)
    for p, m in zip(TP_PROMPTS, TP_MAX_NEW):
        srv.submit(Request(prompt=list(p), max_new_tokens=m))
    toks = np.full((len(TP_PROMPTS), max(TP_MAX_NEW)), -1, np.int64)
    for r in srv.run_continuous():
        toks[r.rid, :len(r.output)] = r.output
    return toks, srv.stats


def run_tp_decode(spec, device):
    """The TP decode step on the job's ("data", "model") mesh, in both
    modes: one teacher-forced step's logits (every rank's are the global
    ones) and its sends, then the job's requests served through
    run_continuous with the step, their tokens, the decode steps and the
    sends."""
    from repro_torch.models.decode_tp import build_decode_step

    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"), device)
    model, params = tp_model(spec, device)
    out = {}
    for mode in ("hdot", "two_phase"):
        step = build_decode_step(model, mesh, mode=mode)
        token, caches, pos = tp_admitted(model, params, spec, device)
        (logits, _), sends = _logged_sends(
            mesh, lambda: step(params, token, caches, pos))
        out[f"tp_{mode}_logits"] = logits.cpu().numpy()
        out[f"tp_{mode}_step_sends"] = np.array(sends)
        (toks, stats), sends = _logged_sends(
            mesh, lambda: tp_serve(model, params, spec, step))
        out[f"tp_{mode}_tokens"] = toks
        out[f"tp_{mode}_decode_steps"] = np.array(stats["decode_steps"])
        out[f"tp_{mode}_sends"] = np.array(sends)
    return out


class _Timed:
    """Times each call of a decode step on the host clock, ending in a
    synchronize (the server reads the chosen ids back every step anyway)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.calls.append(time.perf_counter() - t0)
        return out


def tp_full_prompts(spec, vocab: int):
    """chip_smoke.py phase 8's prompts: lengths uniform in 128-2048 from
    numpy seed 0, token ids uniform in [1, vocab)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 2049, spec["requests"])
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def run_tp_full(spec, device):
    """A model at its published widths (bf16, flash attention, random
    weights from seed 0) served by run_continuous: first on this card
    alone (model.decode_step), then through the TP step on each
    ("data", "model") mesh of ``spec["meshes"]`` in each mode of
    ``spec["modes"]``. For each run: the tokens, the wall time, every
    decode step's time, the sends, the flash launches and the card's
    peak memory. For each TP case also one teacher-forced step after the
    first `slots` requests are admitted (the first token of each request's
    one-card output forced), against model.decode_step on a copy of the
    same caches, and that step once more traced (torch.profiler: its wall
    time, the NCCL time no compute kernel overlaps, and the host ops with
    the most self time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.decode_tp import build_decode_step
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import (BatchServer, Request,
                                            _mark_prefill_tail, _scatter_slot,
                                            _walk, make_slot_caches)

    cfg = get_arch(spec["arch"])
    model = build_model(cfg, ModelOptions(attn_impl="flash",
                                          dtype=torch.bfloat16))
    params = model.init(0, device)
    meshes = [make_mesh(tuple(m), ("data", "model"), device)
              for m in spec["meshes"]]
    prompts = tp_full_prompts(spec, cfg.vocab_size)
    slots, max_len, new = spec["slots"], spec["max_len"], spec["new_tokens"]
    model.prefill(params, {"tokens": torch.tensor([prompts[0][:128]],
                                                  device=device)})  # warm-up
    out = {}

    def serve(tag, step):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        # the one-card run decodes through model.decode_step itself: each
        # rank serves alone, with no broadcast of the chosen ids
        timed = _Timed(step if step is not None else model.decode_step)
        srv = BatchServer(model, params, slots=slots, max_len=max_len,
                          decode_step_fn=timed if step is not None else None)
        if step is None:
            model.decode_step = timed
        for pr in prompts:
            srv.submit(Request(prompt=pr, max_new_tokens=new))
        flash0 = flash_ops.flash_attention.launches
        t0 = time.perf_counter()
        try:
            served, sends = _logged_sends(meshes[0], srv.run_continuous)
        finally:
            if step is None:
                del model.decode_step
        torch.cuda.synchronize(device)
        out[f"{tag}_wall_s"] = np.array(time.perf_counter() - t0)
        toks = np.full((len(prompts), new), -1, np.int64)
        for r in served:
            toks[r.rid, :len(r.output)] = r.output
        out[f"{tag}_tokens"] = toks
        out[f"{tag}_step_s"] = np.array(timed.calls)
        out[f"{tag}_sends"] = np.array(sends)
        out[f"{tag}_prefills"] = np.array(srv.stats["prefills"])
        out[f"{tag}_ids_off_rank0"] = np.array(srv.stats["ids_off_rank0"])
        out[f"{tag}_flash"] = np.array(flash_ops.flash_attention.launches
                                       - flash0)
        out[f"{tag}_peak_bytes"] = np.array(
            torch.cuda.max_memory_allocated(device))
        return toks

    one = serve("one", None)
    for mesh in meshes:
        for mode in spec["modes"]:
            tag = "x".join(map(str, mesh.sizes)) + "_" + mode
            step = build_decode_step(model, mesh, mode=mode)
            serve(tag, step)
            caches = make_slot_caches(model, slots, max_len, device)
            for i, pr in enumerate(prompts[:slots]):
                _, pc = model.prefill(params, {"tokens": torch.tensor(
                    [pr], device=device)}, max_len=max_len)
                _scatter_slot(caches, _mark_prefill_tail(pc, len(pr)), i,
                              slots)
            token = torch.from_numpy(one[:slots, :1].copy()).to(device)
            pos = torch.tensor([len(p) for p in prompts[:slots]],
                               device=device)
            ref = _walk(caches, lambda _, t: t.clone())
            got = step(params, token, caches, pos)[0]
            want = model.decode_step(params, token, ref, pos)[0]
            d = (got - want).abs()
            out[f"{tag}_forced_mean_abs"] = np.array(float(d.mean()))
            out[f"{tag}_forced_max_abs"] = np.array(float(d.max()))
            del ref, got, want, d
            torch.cuda.synchronize(device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()     # the profiler's start excluded
                step(params, token, caches, pos + 1)
                torch.cuda.synchronize(device)
                out[f"{tag}_traced_s"] = np.array(time.perf_counter() - t0)
            for k, v in nccl_exposure(prof).items():
                out[f"{tag}_{k}"] = np.array(v)
            host = sorted(prof.key_averages(),
                          key=lambda e: -e.self_cpu_time_total)[:8]
            out[f"{tag}_host_top"] = np.array(json.dumps(
                [[e.key, e.count, e.self_cpu_time_total / 1e3]
                 for e in host]))
            del step, caches, prof
            torch.cuda.empty_cache()
    return out


def sync_tree(rank: int):
    """Rank `rank`'s gradients for the grad-sync job: integers in [-4, 4]
    in bf16, f32 and f16 (every sum exact), and a scalar 3.0 on every rank
    (summed to 3 times the rank count)."""
    rng = np.random.default_rng(40 + rank)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-4, 5, shape).astype(
            np.float32))
    return {"emb": ints(16, 8).bfloat16(), "w1": ints(33),
            "w2": ints(4, 4).half(), "b": torch.tensor(3.0)}


def run_gradsync(spec, device):
    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    out = {}
    for mode in ("two_phase", "hdot"):
        tree = {k: v.to(device) for k, v in sync_tree(mesh.rank).items()}
        synced = grad_sync(tree, mesh, tuple(spec["axes"]), mode=mode,
                           num_buckets=3)
        for k, v in synced.items():
            out[f"sync_{mode}_{k}"] = v.float().cpu().numpy()
            out[f"sync_{mode}_{k}_dtype"] = np.array(str(v.dtype))
    return out


class _IssueLog:
    """Records every ``dist.all_reduce`` call by the data pointer of its
    tensor and, from post-accumulate-grad hooks on the depth-1 leaves, how
    many calls a step had made when its first gradient of layer 1 was
    ready."""

    def __init__(self):
        self.ptrs, self.at_layer1 = [], []
        self._orig = dist.all_reduce
        self._start = None

    def __call__(self, t, *args, **kw):
        self.ptrs.append(t.data_ptr())
        return self._orig(t, *args, **kw)

    def begin_step(self):
        self._start = len(self.ptrs)

    def layer1_ready(self, p):
        if self._start is not None:
            self.at_layer1.append(len(self.ptrs) - self._start)
            self._start = None


def run_train(spec, workdir, device):
    """Each (overlap, accum_steps) case: a Trainer on the job's mesh,
    restored from ``<workdir>/init`` (step 0), `steps` steps; its losses,
    grad norms, final parameters (flattened in tree order) and, for hdot,
    the bucket index of each all-reduce it issued (-1: the loss's pmean)
    and the calls made before layer 1's first gradient was ready."""
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    out = {}
    for overlap, accum in spec["cases"]:
        run = RunConfig(
            model=get_arch(spec["arch"]).reduced(),
            parallel=ParallelConfig(overlap=overlap, accum_steps=accum,
                                    remat="none", scan_layers=False),
            train=TrainConfig(global_batch=spec["global_batch"],
                              seq_len=spec["seq_len"], lr=spec["lr"],
                              warmup_steps=2, total_steps=spec["steps"],
                              checkpoint_every=10 ** 6, seed=3,
                              checkpoint_dir=str(workdir / "init")))
        t = Trainer(run, mesh=mesh, options=ModelOptions(
            dtype=torch.float32, scan_layers=False))
        assert t.restore_if_available() and t.step == 0
        log = _IssueLog()
        hooks = [p.register_post_accumulate_grad_hook(log.layer1_ready)
                 for p, d in zip(tree_leaves(t.params),
                                 tree_leaves(t.model.param_layers()))
                 if d == 1]
        dist.all_reduce = log
        try:
            for _ in range(spec["steps"]):
                log.begin_step()
                t.train(1)
        finally:
            dist.all_reduce = log._orig
            for h in hooks:
                h.remove()
        tag = f"{overlap}{accum}"
        for key in ("loss", "grad_norm", "lr"):
            out[f"{tag}_{key}"] = np.array([m[key] for m in t.metrics_log])
        out[f"{tag}_params"] = torch.cat(
            [p.detach().reshape(-1).float() for p in tree_leaves(t.params)]
        ).cpu().numpy()
        buckets = t._step_fn.buckets
        if buckets is not None:
            where = {f.data_ptr(): k for k, fs in enumerate(buckets.flats)
                     for f in fs}
            out[f"{tag}_issued"] = np.array([where.get(q, -1)
                                             for q in log.ptrs])
            out[f"{tag}_at_layer1"] = np.array(log.at_layer1)
            out[f"{tag}_buckets"] = np.array(json.dumps(buckets.buckets))
    return out


def params_close(got, want, leaves, rtol=1e-4):
    """Two parameter vectors flattened in tree order (`leaves` gives the
    leaf sizes) within `rtol` of each other, leaf by leaf, relative to
    each leaf's largest entry (as tests/test_torch_trainer.py holds the
    one-rank Trainer against JAX's)."""
    off = 0
    for p in leaves:
        a, b = got[off:off + p.numel()], want[off:off + p.numel()]
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())
        off += p.numel()
    assert off == len(want) == len(got)


def params_close_tiny_v(got, want, leaves, v, lr_sum, rtol=1e-4):
    """:func:`params_close`, except where the reference's AdamW second
    moment `v` (flattened like `want`) is below (1e3 * eps)^2
    (``tests/test_torch_trainer.py::test_moe_trainer_matches_jax``'s
    rule): there AdamW divides a gradient of about eps by one of about
    eps, so last-bit differences of the gradient become O(1) differences
    of the step, and an entry may differ by up to the summed learning
    rates `lr_sum`."""
    from repro_torch.config.base import TrainConfig

    eps = TrainConfig().eps
    off = 0
    for p in leaves:
        n = p.numel()
        a, b, vv = got[off:off + n], want[off:off + n], v[off:off + n]
        tiny = (vv > 0) & (vv < (1e3 * eps) ** 2)
        np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=rtol,
                                   atol=rtol * np.abs(b).max())
        assert (np.abs(a[tiny] - b[tiny]) <= lr_sum).all()
        off += n
    assert off == len(want) == len(got)


def check_issue_order(ranks, spec):
    """Every rank's hdot all-reduces in each step were the buckets of
    make_buckets(order="reverse_topo") in emission order, then the loss's
    pmean; with one microbatch, the buckets deeper than layer 1 had been
    issued when layer 1's first gradient was ready. Returns the buckets."""
    from repro_torch.config.registry import get_arch
    from repro_torch.core.overlap import make_buckets
    from repro_torch.models.model import ModelOptions, build_model

    model = build_model(get_arch(spec["arch"]).reduced(),
                        ModelOptions(dtype=torch.float32, scan_layers=False))
    want = [[i for i, _ in b] for b in make_buckets(
        model.init(0, "cpu"), 8, model.param_layers(), "reverse_topo")]
    depth = tree_leaves(model.param_layers())
    layer1 = [k for k, b in enumerate(want) if {depth[i] for i in b} == {1}]
    assert layer1 and all(min(depth[i] for i in b) > 1
                          for b in want[:layer1[0]])
    per_step = list(range(len(want))) + [-1]
    for out in ranks:
        for overlap, accum in spec["cases"]:
            if overlap != "hdot":
                continue
            assert json.loads(str(out[f"hdot{accum}_buckets"])) == want
            assert out[f"hdot{accum}_issued"].tolist() == (
                per_step * spec["steps"])
        assert out["hdot1_at_layer1"].tolist() == [layer1[0]] * spec["steps"]
    return want


# ParallelConfig fields of each ZeRO-3 case: gathering all on the per-layer
# layout, and streaming (the reference's comparator pair); "repl" is the
# replicated trainer with the same options
ZERO3_CASES = {
    "gather": dict(param_shard=True, scan_layers=False, remat="full",
                   bucket_order="layer"),
    "stream": dict(param_shard=True, fsdp_streaming=True, scan_layers=False,
                   remat="full"),
    "repl": dict(scan_layers=False, remat="full"),
}


def zero3_trainer(spec, case, mesh, device):
    """A Trainer of the ZeRO-3 job's model (its arch, reduced unless
    ``spec["full"]``; float32 unless ``spec["dtype"]`` says "bf16"; with
    ``spec["accum"]`` microbatches, default 1) under
    `case` of ZERO3_CASES on `mesh` (None: no mesh), with the options the
    cases share: unrolled, remat "full", the unfused loss."""
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions
    from repro_torch.runtime.trainer import Trainer

    cfg = get_arch(spec["arch"])
    if not spec.get("full"):
        cfg = cfg.reduced()
    if spec.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    dtype = torch.bfloat16 if spec.get("dtype") == "bf16" else torch.float32
    steps = spec["steps"]
    run = RunConfig(
        model=cfg, parallel=ParallelConfig(
            accum_steps=spec.get("accum", 1), **ZERO3_CASES[case]),
        train=TrainConfig(global_batch=spec["global_batch"],
                          seq_len=spec["seq_len"], lr=spec["lr"],
                          warmup_steps=max(1, steps // 10),
                          total_steps=steps, checkpoint_every=10 ** 9,
                          seed=3, **({"checkpoint_dir": spec["ckpt"]}
                                     if "ckpt" in spec else {})))
    return Trainer(run, mesh=mesh, device=device, options=ModelOptions(
        dtype=dtype, scan_layers=False, remat="full", fused_xent=False))


def run_zero3(spec, device):
    """Each case of ``spec["cases"]`` on the job's mesh: a ZeRO-3 Trainer
    initialised from seed 0 (each rank drawing its shards bucket by
    bucket) and its initial shards kept, `steps` steps with its
    collectives logged; its losses, grad norms, the full parameters (gathered, flattened in tree order), this
    rank's shards of params and moments (concatenated in layout order; the
    moments after the first step too) and their sizes, whether every padding element of the global buffers is
    zero, and the log."""
    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    out = {}
    for case in spec["cases"]:
        t = zero3_trainer(spec, case, mesh, device)
        t.init_state(seed=0)
        layout = t._fsdp_layout
        tag = f"z3{case}"
        out[f"{tag}_init"] = torch.cat(
            [t.params[k].detach().float() for k in layout.keys]).cpu().numpy()
        t.fsdp_log = []
        t.train(1)
        for name in ("m", "v"):      # the moments after the first step
            out[f"{tag}_shard_{name}1"] = torch.cat(
                [t.opt_state[name][k].detach().float()
                 for k in layout.keys]).cpu().numpy()
        t.train(spec["steps"] - 1)
        for key in ("loss", "grad_norm"):
            out[f"{tag}_{key}"] = np.array([m[key] for m in t.metrics_log])
        out[f"{tag}_params"] = torch.cat(
            [p.detach().reshape(-1).float() for p in
             tree_leaves(t.full_params())]).cpu().numpy()
        pad_zero = True
        for name, flat in (("p", t.params), ("m", t.opt_state["m"]),
                           ("v", t.opt_state["v"])):
            out[f"{tag}_shard_{name}"] = torch.cat(
                [flat[k].detach().float() for k in layout.keys]).cpu().numpy()
            full = t._global_flat(flat)
            pad_zero &= all(not full[g.key][g.size:].any()
                            for g in layout.groups)
        out[f"{tag}_pad_zero"] = np.array(pad_zero)
        out[f"{tag}_shard_sizes"] = np.array(
            [t.params[k].numel() for k in layout.keys])
        out[f"{tag}_padded"] = np.array([g.padded for g in layout.groups])
        out[f"{tag}_keys"] = np.array(list(layout.keys))
        out[f"{tag}_log"] = np.array([f"{w}:{k}" for w, k in t.fsdp_log])
    return out


def _busy(intervals) -> list:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """The length of the intersection of two disjoint sorted interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def nccl_exposure(prof) -> dict:
    """Device time of one traced step from a torch.profiler run: the NCCL
    kernels' busy time, the other device work's (compute, copies), and the
    NCCL time none of that overlaps (ms)."""
    from torch.autograd import DeviceType

    comm, comp = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            iv = (ev.time_range.start, ev.time_range.end)
            (comm if "nccl" in ev.name.lower() else comp).append(iv)
    comm, comp = _busy(comm), _busy(comp)
    comm_us = sum(b - a for a, b in comm)
    hidden = _overlap(comm, comp)
    return {"nccl_ms": comm_us / 1e3,
            "compute_ms": sum(b - a for a, b in comp) / 1e3,
            "nccl_exposed_ms": (comm_us - hidden) / 1e3}


def run_zero3_full(spec, device):
    """Streaming ZeRO-3 at a published width on the job's ("data",) mesh:
    bf16, init from seed 0 bucket by bucket, ``spec["steps"]`` steps (the
    first a warm-up) with the host clock around each (synchronised), then,
    with ``spec["trace"]``, one more step traced on every rank
    (torch.profiler; the NCCL time no compute kernel overlaps). Returns
    the losses, grad norms, step times, this card's peak memory and
    parameter-shard bytes."""
    mesh = make_mesh(tuple(spec["mesh"]), ("data",), device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    t = zero3_trainer(dict(spec, full=True, dtype="bf16"), "stream", mesh,
                      device)
    t.init_state(seed=0)
    torch.cuda.synchronize(device)
    out = {"init_s": np.array(time.perf_counter() - t0)}
    times = []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize(device)
        ts = time.perf_counter()
        t.train(1)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - ts)
    out["peak_bytes"] = np.array(torch.cuda.max_memory_allocated(device))
    if spec.get("trace"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t.train(1)
            torch.cuda.synchronize(device)
        for k, v in nccl_exposure(prof).items():
            out[k] = np.array(v)
    out.update(step_s=np.array(times),
               loss=np.array([m["loss"] for m in t.metrics_log]),
               grad_norm=np.array([m["grad_norm"] for m in t.metrics_log]),
               shard_bytes=np.array(t._fsdp_layout.shard_bytes()),
               n_params=np.array(t.run.model.num_params()))
    return out


# ------------------------------------------------ tensor-parallel training
CASE_OVERRIDES = ("vocab", "heads", "ssm_head_dim", "ssm_expand", "capacity",
                  "experts", "enc_seq")
# the overrides that change the parameter tree
TREE_OVERRIDES = ("heads", "ssm_head_dim", "ssm_expand", "experts")


def case_cfg(cfg, case):
    """`cfg`, a reduced config of either package, with a TP case's
    overrides: ``vocab`` (the vocab size), ``heads`` (the query heads),
    ``ssm_head_dim`` and ``ssm_expand`` (Mamba-2's head dim and
    ``d_inner / d_model``, so its head count), ``capacity`` (the MoE
    capacity factor), ``experts`` (the MoE expert count), ``enc_seq``
    (the encoder-decoder's frame count)."""
    import dataclasses

    kw, ssm, moe = {}, {}, {}
    if case.get("capacity"):
        moe["capacity_factor"] = case["capacity"]
    if case.get("experts"):
        moe["num_experts"] = case["experts"]
    if moe:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe)
    if case.get("enc_seq"):
        kw["encdec"] = dataclasses.replace(cfg.encdec,
                                           enc_seq=case["enc_seq"])
    if case.get("vocab"):
        kw["vocab_size"] = case["vocab"]
    if case.get("heads"):
        kw["num_heads"] = case["heads"]
    if case.get("ssm_head_dim"):
        ssm["head_dim"] = case["ssm_head_dim"]
    if case.get("ssm_expand"):
        ssm["expand"] = case["ssm_expand"]
    if ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, **ssm)
    return dataclasses.replace(cfg, **kw)


def tp_run(spec, case, ckpt_dir):
    """(RunConfig, ModelOptions) of a TP-training case: the reduced `arch`
    with the case's overrides (:func:`case_cfg`), float32,
    ``case["scan"]`` layers, ``case["accum"]`` microbatches, remat
    ``case["remat"]`` (default "none"), the unfused loss where
    ``case["unfused"]``, ``case["seq"]`` tokens a row where given (else
    the spec's), ``case["chunks"]`` MoE all-to-all slices (default 1),
    restoring from `ckpt_dir`."""
    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions

    cfg = case_cfg(get_arch(case["arch"]).reduced(), case)
    run = RunConfig(
        model=cfg,
        parallel=ParallelConfig(accum_steps=case["accum"],
                                remat=case.get("remat", "none"),
                                scan_layers=case["scan"],
                                moe_a2a_chunks=case.get("chunks", 1)),
        train=TrainConfig(global_batch=spec["global_batch"],
                          seq_len=case.get("seq", spec["seq_len"]),
                          lr=spec["lr"],
                          warmup_steps=2, total_steps=spec["total_steps"],
                          checkpoint_every=10 ** 6, seed=3,
                          checkpoint_dir=str(ckpt_dir)))
    return run, ModelOptions(dtype=torch.float32, scan_layers=case["scan"],
                             remat=run.parallel.remat,
                             fused_xent=not case.get("unfused"),
                             moe_a2a_chunks=run.parallel.moe_a2a_chunks)


def tp_init_key(case) -> str:
    """The name of a case's initial checkpoint (one per parameter tree)."""
    more = "".join(f"-{k}{case[k]}" for k in TREE_OVERRIDES if case.get(k))
    return (f"{case['arch']}-v{case.get('vocab') or 0}-s{int(case['scan'])}"
            + more)


def flat(tree) -> np.ndarray:
    """Every leaf of `tree`, flattened in tree order, as float32."""
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in tree_leaves(tree)]).numpy()


def _private_copy(src: Path, dst: Path, mesh) -> Path:
    """`src` copied to `dst` by rank 0, seen by every rank after."""
    import shutil

    if mesh.rank == 0:
        shutil.copytree(src, dst)
    if dist.is_initialized():
        dist.barrier()
    return dst


def _blocks_index(t) -> np.ndarray:
    return np.array(json.dumps([[[s.start, s.stop] for s in sh.index]
                                for sh in t._tp.shardings]))


def run_tp_train(spec, workdir, device):
    """Each TP case: a Trainer on the job's mesh restored from its initial
    checkpoint (``<workdir>/init_<key>``, step 0), its blocks as restored
    and their index ranges, ``spec["steps"]`` steps (the scans counted,
    :func:`scans_counted`), then its losses,
    grad norms and full parameters (unsharded on every rank). A case with
    ``save`` trains from a private copy of the checkpoint and saves its
    state there at the end (``<workdir>/ck_<tag>``); one with ``log``
    records its MoE all-to-alls, forward and backward, in issue order
    (``<tag>_a2a``, JSON of ``TPCut.a2a_log``); one with ``moments`` its
    final AdamW second moments (``<tag>_v``). ``spec["seed"]``
    inits a trainer of that case from seed 5 instead and records its
    blocks."""
    from repro_torch.runtime.trainer import Trainer

    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    out = {}
    for case in spec["cases"]:
        tag = case["tag"]
        ck = workdir / f"init_{tp_init_key(case)}"
        if case.get("save"):
            ck = _private_copy(ck, workdir / f"ck_{tag}", mesh)
        run, opts = tp_run(spec, case, ck)
        t = Trainer(run, mesh=mesh, options=opts)
        assert t.restore_if_available() and t.step == 0
        out[f"{tag}_blocks0"] = flat(t.params)
        out[f"{tag}_index"] = _blocks_index(t)
        if case.get("log"):
            t._tp.cut.a2a_log = []
        with scans_counted() as counts:
            t.train(spec["steps"])
        if case.get("log"):
            out[f"{tag}_a2a"] = np.array(json.dumps(t._tp.cut.a2a_log))
        out[f"{tag}_launches"] = np.array(counts["launches"])
        out[f"{tag}_plain_calls"] = np.array(counts["plain"])
        for key in ("loss", "grad_norm", "lr"):
            out[f"{tag}_{key}"] = np.array([m[key] for m in t.metrics_log])
        out[f"{tag}_params"] = flat(t.full_params())
        if case.get("moments"):
            out[f"{tag}_v"] = flat(t._unshard(t.opt_state["v"]))
        if case.get("save"):
            t.save()
            t.ckpt.wait()
    if "seed" in spec:
        run, opts = tp_run(spec, spec["seed"], workdir / "none")
        t = Trainer(run, mesh=mesh, options=opts)
        t.init_state(seed=5)
        out["seed_blocks"] = flat(t.params)
        out["seed_index"] = _blocks_index(t)
        out["seed_full"] = flat(t.full_params())
    return out


def run_tp_elastic(spec, workdir, device):
    """Restore a TP trainer's checkpoint (``spec["src"]``, saved at step
    ``spec["at"]``) onto each mesh of ``spec["meshes"]`` over this job's
    ranks, each from a private copy: the restored full parameters and AdamW
    moments, then ``spec["steps"]`` more steps' losses, grad norms and full
    parameters."""
    from repro_torch.runtime.trainer import Trainer

    case = spec["case"]
    out = {}
    for shape in spec["meshes"]:
        tag = "m" + "x".join(map(str, shape))
        mesh = make_mesh(tuple(shape), ("data", "model"), device)
        ck = _private_copy(Path(spec["src"]), workdir / f"ck_{tag}", mesh)
        run, opts = tp_run(spec, case, ck)
        t = Trainer(run, mesh=mesh, options=opts)
        assert t.restore_if_available() and t.step == spec["at"]
        if t._tp is not None:
            m, v = (t._unshard(t.opt_state[k]) for k in ("m", "v"))
        else:
            m, v = t.opt_state["m"], t.opt_state["v"]
        out[f"{tag}_restored"] = flat(t.full_params())
        out[f"{tag}_m"], out[f"{tag}_v"] = flat(m), flat(v)
        out[f"{tag}_opt_step"] = np.array(int(t.opt_state["step"]))
        t.train(spec["steps"])
        for key in ("loss", "grad_norm"):
            out[f"{tag}_{key}"] = np.array([m_[key] for m_ in t.metrics_log])
        out[f"{tag}_params"] = flat(t.full_params())
    return out


def run_tp_units(spec, device):
    """The TP cut's building blocks on each ("data", "model") mesh of
    ``spec["meshes"]``, forward and backward, against the same math on
    one rank (computed here, without collectives): ``<tag>_<unit>_got``
    and ``..._want`` for the autograd all-reduce, the width-block narrow
    (``TPCut.cols``), the grouped RMS norm, the RG-LRU gates'
    reduce-scatter, and the all-reduces' backward on a strided gradient
    (contiguous at every ``dist.all_reduce``). Inputs every rank holds whole are drawn from one
    seed; each rank's own inputs from the seed plus its rank. The
    gradients of a whole input are summed over the model line, as the
    train step sums them (the loss is the sum of the ranks' losses)."""
    from repro_torch.models.layers import rms_norm, rms_norm_split
    from repro_torch.sharding.tp import TPCut, all_reduce, grad_all_reduce

    def draw(seed, *shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g)

    out = {}
    for shape in spec["meshes"]:
        tag = "m" + "x".join(map(str, shape))
        mesh = make_mesh(tuple(shape), ("data", "model"), device)
        n, i = shape[1], mesh.coords[1]
        line = [mesh.coords[0] * n + k for k in range(n)]
        cut = TPCut(mesh, "model", n, i, heads=True, kv_heads=True,
                    mlp=True, inner=True, ssm_heads=True, lru=True)
        w = 6 * n
        blk = slice(i * 6, (i + 1) * 6)

        def line_sum(t):
            return all_reduce(t, mesh, ("model",)).detach()

        # the autograd all-reduce: sum forward, sum backward
        x = draw(10 + mesh.rank, 3, 4).requires_grad_()
        y = cut.all_reduce(x)
        (y * draw(20 + mesh.rank, 3, 4)).sum().backward()
        out[f"{tag}_allreduce_got"] = torch.cat(
            [y.detach().reshape(-1), x.grad.reshape(-1)]).numpy()
        want = [sum(draw(10 + r, 3, 4) for r in line),
                sum(draw(20 + r, 3, 4) for r in line)]
        out[f"{tag}_allreduce_want"] = torch.cat(
            [t.reshape(-1) for t in want]).numpy()

        # the width-block narrow: the rank's block; the backward pads zeros
        v = draw(30, w).requires_grad_()
        b = cut.cols(v)
        g = draw(40 + mesh.rank, 6)
        (b * g).sum().backward()
        pad = torch.zeros(w)
        pad[blk] = g
        out[f"{tag}_cols_got"] = torch.cat([b.detach(), v.grad]).numpy()
        out[f"{tag}_cols_want"] = torch.cat([v.detach()[blk], pad]).numpy()

        # the grouped RMS norm over the split width
        X, wt, G = (draw(50, 2, 5, w).requires_grad_(),
                    draw(51, w).requires_grad_(), draw(52, 2, 5, w))
        y = rms_norm_split(cut.cols(X), cut.cols(wt), 1e-6, w,
                           cut.all_reduce)
        (y * cut.cols(G)).sum().backward()
        got = [y.detach(), line_sum(X.grad), line_sum(wt.grad)]
        X2, wt2 = (t.detach().clone().requires_grad_() for t in (X, wt))
        y2 = rms_norm(X2, wt2, 1e-6)
        (y2 * G).sum().backward()
        want = [y2.detach()[..., blk], X2.grad, wt2.grad]
        out[f"{tag}_norm_got"] = torch.cat(
            [t.reshape(-1) for t in got]).numpy()
        out[f"{tag}_norm_want"] = torch.cat(
            [t.reshape(-1) for t in want]).numpy()

        # the RG-LRU gates: the rank's rows of wr (placed ("lru", None))
        # give a partial sum over the width, reduce-scattered to its block
        U, wr, G = (draw(60, 2, 5, w).requires_grad_(), draw(61, w, w),
                    draw(62, 2, 5, w))
        wr_blk = wr[blk].clone().requires_grad_()
        r = cut.scatter_cols(cut.cols(U) @ wr_blk)
        (r * cut.cols(G)).sum().backward()
        got = [r.detach(), line_sum(U.grad), wr_blk.grad]
        U2, wr2 = (t.detach().clone().requires_grad_() for t in (U, wr))
        r2 = U2 @ wr2
        (r2 * G).sum().backward()
        want = [r2.detach()[..., blk], U2.grad, wr2.grad[blk]]
        out[f"{tag}_gates_got"] = torch.cat(
            [t.reshape(-1) for t in got]).numpy()
        out[f"{tag}_gates_want"] = torch.cat(
            [t.reshape(-1) for t in want]).numpy()

        # a gradient that reaches the all-reduces strided (here through a
        # transpose) is summed from a contiguous copy: NCCL refuses a
        # strided tensor, gloo takes it, so the calls are checked here
        contiguous = []

        def checked(t, *a, **k):
            contiguous.append(float(t.is_contiguous()))
            return reduce_all(t, *a, **k)

        reduce_all, dist.all_reduce = dist.all_reduce, checked
        try:
            z1, z2 = (draw(70 + k, 6, 4).requires_grad_() for k in (0, 1))
            G = draw(80 + mesh.rank, 4, 6)
            ((grad_all_reduce(z1, mesh, ("model",)).t() * G).sum()
             + (cut.all_reduce(z2).t() * G).sum()).backward()
        finally:
            dist.all_reduce = reduce_all
        want_g = sum(draw(80 + r, 4, 6) for r in line).t()
        out[f"{tag}_strided_got"] = np.concatenate(
            [z1.grad.reshape(-1).numpy(), z2.grad.reshape(-1).numpy(),
             contiguous])
        out[f"{tag}_strided_want"] = np.concatenate(
            [want_g.reshape(-1).numpy()] * 2 + [np.ones(3)])
    return out


def tp_full_run(spec, workdir):
    """(RunConfig, ModelOptions) of the full-width TP job: ``spec["arch"]``
    at its published widths (reduced where ``spec["reduced"]``, for a
    rehearsal), ``spec["layers"]`` of its layers where given (the depth
    cut), bf16 (float32 where ``spec["f32"]``), unrolled (scanned where
    ``spec["scan"]``), remat ``spec["remat"]`` (default "full"), AdamW,
    ``spec["global_batch"]`` x ``spec["seq_len"]`` tokens a step, data
    seed 3; a MoE model's all-to-alls in ``spec["chunks"]`` slices
    (default 1), its capacity factor ``spec["capacity"]`` and its expert
    count ``spec["experts"]`` where given."""
    import dataclasses

    from repro_torch.config.base import ParallelConfig, RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.models.model import ModelOptions

    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced()
    if spec.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    moe = {k: spec[f] for k, f in (("capacity_factor", "capacity"),
                                    ("num_experts", "experts")) if spec.get(f)}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    steps = spec["steps"] + 1
    scan = bool(spec.get("scan"))
    remat, chunks = spec.get("remat", "full"), spec.get("chunks", 1)
    run = RunConfig(
        model=cfg, parallel=ParallelConfig(remat=remat, scan_layers=scan,
                                           moe_a2a_chunks=chunks),
        train=TrainConfig(global_batch=spec["global_batch"],
                          seq_len=spec["seq_len"], lr=spec["lr"],
                          warmup_steps=max(1, steps // 10),
                          total_steps=steps, checkpoint_every=10 ** 9,
                          seed=3, checkpoint_dir=str(workdir / "ck")))
    dtype = torch.float32 if spec.get("f32") else torch.bfloat16
    return run, ModelOptions(dtype=dtype, scan_layers=scan, remat=remat,
                             moe_a2a_chunks=chunks)


def tp_full_reference(spec, device, rows: int = 2) -> dict:
    """The loss of ``tp_full_run``'s first batch under its seed-0 weights
    on one device, forward only, `rows` sequences at a time: in the run's
    dtype ("one") and with the same weights widened to float32 ("f32").
    A MoE model's aux loss averages its expert loads over the rows it
    sees, so it takes `rows` = the whole batch."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.layers import ParamTree, tree_map
    from repro_torch.models.model import build_model

    run, opts = tp_full_run(spec, Path("."))
    cfg = run.model
    opts = dataclasses.replace(opts, remat="none")
    batch = SyntheticLMDataset(cfg.vocab_size, run.train.seq_len,
                               run.train.global_batch,
                               seed=run.train.seed).batch_at(0)
    b = run.train.global_batch
    if cfg.family == "encdec":      # the trainer's frontend stubs
        batch["frames"] = np.full((b, cfg.encdec.enc_seq, cfg.d_model),
                                  0.02, np.float32)
    if cfg.family == "vlm":
        batch["patches"] = np.full((b, cfg.num_vision_patches, cfg.d_model),
                                   0.02, np.float32)

    def loss(model, params) -> float:
        parts = []
        with torch.no_grad():
            for i in range(0, run.train.global_batch, rows):
                mb = {k: torch.from_numpy(v[i:i + rows]).to(
                          device, torch.int64 if v.dtype.kind in "iu"
                          else None) for k, v in batch.items()}
                parts.append(model.train_loss(params, mb).double())
        return float(torch.stack(parts).mean())

    model = build_model(cfg, opts)
    params = model.init(0, device)
    out = {"one": loss(model, params)}
    params = ParamTree(tree_map(lambda w: w.float(), params))
    out["f32"] = loss(build_model(cfg, dataclasses.replace(
        opts, dtype=torch.float32)), params)
    return out


def run_tp_train_full(spec, workdir, device):
    """TP training of ``tp_full_run``'s model on each ("data", "model")
    mesh of ``spec["meshes"]`` in turn (results keyed ``<prefix>m<mesh>``,
    ``spec["prefix"]`` default ""), one trainer at a time: init from
    seed 0 (leaf by leaf, each rank keeping its blocks), ``spec["steps"]``
    steps (the first a warm-up) with the host clock around each
    (synchronised), then, with ``spec["trace"]``, one more step traced on
    every rank (torch.profiler; the NCCL time no compute kernel overlaps,
    the traced step's wall time, the host ops with the most self time and
    the CUDA runtime calls made 32 times or more). For each mesh: losses,
    grad norms, step times, the scans' kernel launches over the timed
    steps and the calls of their plain versions (:func:`scans_counted`),
    a MoE model's all-to-alls a step (forward, recompute and backward:
    the cut's ``a2a_log``) and the share of routed assignments capacity
    dropped (:func:`moe_drops_counted`), and on a card the bytes
    allocated at rest (params and moments) against the sum of this rank's
    blocks, the peak, and the last timed step's bytes held before it
    (``_step_held``) and its peak (``_step_peak``, the counter reset
    just before it), both over the bytes allocated before the trainer."""
    import gc

    from repro_torch.runtime.trainer import Trainer

    cuda = torch.device(device).type == "cuda"

    def allocated():
        return torch.cuda.memory_allocated(device) if cuda else 0

    out = {}
    for shape in spec["meshes"]:
        tag = spec.get("prefix", "") + "m" + "x".join(map(str, shape))
        mesh = make_mesh(tuple(shape), ("data", "model"), device)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        base = allocated()
        run, opts = tp_full_run(spec, workdir)
        t0 = time.perf_counter()
        t = Trainer(run, mesh=mesh, options=opts, device=device)
        t.init_state(seed=0)
        if spec.get("gather_all"):
            from repro_torch.analysis.lint_targets import gather_all_tp_step

            t._step_fn = gather_all_tp_step(
                t.model, run.parallel, t._tp, t.opt_cfg,
                run.train.warmup_steps, run.train.total_steps)
        if cuda:
            torch.cuda.synchronize(device)
        out[f"{tag}_init_s"] = np.array(time.perf_counter() - t0)
        out[f"{tag}_rest_bytes"] = np.array(allocated() - base)
        out[f"{tag}_block_bytes"] = np.array(sum(
            x.numel() * x.element_size() for x in tree_leaves(
                {"p": t.params, "o": t.opt_state})))
        times = []
        moe = t.run.model.family == "moe"
        if moe:
            t._tp.cut.a2a_log = []
        with scans_counted() as counts, moe_drops_counted() as drops:
            for i in range(spec["steps"]):
                if cuda:
                    torch.cuda.synchronize(device)
                if cuda and i == spec["steps"] - 1:
                    out[f"{tag}_step_held"] = np.array(allocated() - base)
                    init_peak = torch.cuda.max_memory_allocated(device)
                    torch.cuda.reset_peak_memory_stats(device)
                ts = time.perf_counter()
                t.train(1)
                if cuda:
                    torch.cuda.synchronize(device)
                times.append(time.perf_counter() - ts)
        out[f"{tag}_launches"] = np.array(counts["launches"])
        out[f"{tag}_plain_calls"] = np.array(counts["plain"])
        if moe:
            out[f"{tag}_a2a_per_step"] = np.array(len(
                [e for e in t._tp.cut.a2a_log if e[0] != "compute"])
                / spec["steps"])
            out[f"{tag}_dropped_share"] = np.array(drops["share"])
            t._tp.cut.a2a_log = None
        if cuda:
            step_peak = torch.cuda.max_memory_allocated(device)
            out[f"{tag}_step_peak"] = np.array(step_peak - base)
            out[f"{tag}_peak_bytes"] = np.array(max(init_peak, step_peak)
                                                - base)
        else:
            out[f"{tag}_peak_bytes"] = np.array(0)
        if spec.get("trace"):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                ts = time.perf_counter()
                t.train(1)
                if cuda:
                    torch.cuda.synchronize(device)
                out[f"{tag}_traced_s"] = np.array(time.perf_counter() - ts)
            for k, v in nccl_exposure(prof).items():
                out[f"{tag}_{k}"] = np.array(v)
            avg = prof.key_averages()
            host = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:12]
            out[f"{tag}_host_top"] = np.array(json.dumps(
                [[e.key, e.count, e.self_cpu_time_total / 1e3]
                 for e in host]))
            out[f"{tag}_runtime_calls"] = np.array(json.dumps(
                {e.key: [e.count, e.self_cpu_time_total / 1e3] for e in avg
                 if e.key.startswith("cuda") and e.count >= 32}))
        out[f"{tag}_step_s"] = np.array(times)
        for key in ("loss", "grad_norm"):
            out[f"{tag}_{key}"] = np.array([m[key] for m in t.metrics_log])
        if spec.get("lint"):
            from repro_torch.analysis.lint_targets import tp_train_ctx

            lint_out(out, tag, *logged_step(t, mesh), tp_train_ctx(
                f"{tag}_tp_train", t._tp, run.model, run.parallel))
        del t
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_scans_counted():
    """While entered, counts the calls of the scans' plain versions (the
    LRU scan and the SSD chunk terms): a training path on a card must
    make none."""
    from repro_torch.kernels.lru_scan import ref as lru_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    calls = {"lru_scan_ref": 0, "ssd_chunk_terms": 0}
    saved = [(mod, name, getattr(mod, name))
             for mod, name in ((lru_ref, "lru_scan_ref"),
                               (ssd_ref, "ssd_chunk_terms"))]
    for mod, name, fn in saved:
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def moe_drops_counted():
    """While entered, counts on the device the routed assignments of
    every MoE dispatch (``moe._dispatch_tables``) and those capacity
    dropped; on leaving, ``["share"]`` is the dropped share (a remat
    recompute routes again and counts again: the share is the same)."""
    from repro_torch.models import moe

    orig = moe._dispatch_tables
    tally = {"dropped": 0, "routed": 0}

    def counted(assign, e, c):
        out = orig(assign, e, c)
        tally["dropped"] = tally["dropped"] + (~out[2]).sum()
        tally["routed"] += out[2].numel()
        return out
    moe._dispatch_tables = counted
    got = {}
    try:
        yield got
    finally:
        moe._dispatch_tables = orig
    got["share"] = int(tally["dropped"]) / max(tally["routed"], 1)


@contextlib.contextmanager
def scans_counted():
    """While entered, the scans' wrapper counts start from 0 and the
    plain versions' calls are counted; on leaving, ``["launches"]`` holds
    [ssd_scan, ssd_chunk_bwd, lru_scan, lru_scan_bwd] launches and
    ``["plain"]`` [lru_scan_ref, ssd_chunk_terms] calls."""
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    wrappers = (ssd_ops.ssd, lru_ops.lru_scan)
    for w in wrappers:
        w.launches = w.bwd_launches = 0
    counts = {}
    with plain_scans_counted() as plain:
        yield counts
    counts["launches"] = [n for w in wrappers
                          for n in (w.launches, w.bwd_launches)]
    counts["plain"] = [plain["lru_scan_ref"], plain["ssd_chunk_terms"]]


def _bucket(key: str) -> int:
    return int(key[1:key.index("_")])


def check_zero3_log(log, keys, streaming: bool, steps: int,
                    working_set: int = 2) -> None:
    """The issue order of a ZeRO-3 run's collectives (``"ag:<key>"``,
    ``"rs:<key>"``, ``"free:<key>"``), for an untied model on the
    per-layer layout, whose bucket b is forward depth b. Gathering all,
    each step gathers every buffer once in forward layout order, then
    reduce-scatters each once in reverse layout order. Streaming, each
    step gathers in forward depth order (embedding, layers, head), then
    regathers the layers in reverse depth order in the backward and
    reduce-scatters each buffer once, in reverse layout order, a layer's
    before the layer two below it is regathered; and never are more than
    `working_set` buckets' gathered buffers live at once."""
    keys = [str(k) for k in keys]
    events = [tuple(str(e).split(":")) for e in log]
    ags = [k for w, k in events if w == "ag"]
    rss = [k for w, k in events if w == "rs"]
    last = _bucket(keys[-1])
    regather = [k for b in range(last - 1, 0, -1) for k in keys
                if _bucket(k) == b]
    per_step = keys + regather if streaming else keys
    assert ags == per_step * steps, (ags, per_step)
    assert rss == keys[::-1] * steps, rss
    if not streaming:
        return
    live, worst = set(), 0
    for w, k in events:
        if w == "ag":
            live.add(k)
        elif w == "free":
            live.discard(k)
        worst = max(worst, len({_bucket(x) for x in live}))
    assert worst <= working_set, worst
    issued = [(w, _bucket(k)) for w, k in events if w in ("ag", "rs")]
    step = issued[len(keys):len(per_step) + len(keys)]  # step 1's backward
    for b in range(last - 1, 2, -1):
        assert step.index(("rs", b)) < step.index(("ag", b - 2)), (b, step)


# ------------------------------------------------ the schedule linter
def logged_step(t, mesh):
    """One more step of trainer `t` under the issue-order recorder
    (``analysis.comm_log.record``), its params and moments the state; a
    ZeRO-3 trainer's step is built anew inside it, so that its ("ag" |
    "rs" | "free", key) events land in the log. Returns (log, step)."""
    from repro_torch.analysis.comm_log import record

    with record(mesh) as log:
        if t._fsdp_layout is not None:
            t.fsdp_log, t._step_fn = log.fsdp_sink(), None
        log.mark_state((t.params, t.opt_state))
        t.train(1)
        log.mark_state((t.params, t.opt_state), after=True)
    return log, t._step_fn


def lint_out(out, tag, log, step, ctx):
    """The linter's report on `log` under `ctx`, into the job's output:
    ``<tag>_lint_ok``, ``<tag>_lint`` (the report as JSON) and the
    log's length."""
    from repro_torch.analysis.schedule_lint import lint_log

    rep = lint_log(log, ctx)
    out[f"{tag}_lint_ok"] = np.array(rep.ok)
    out[f"{tag}_lint"] = np.array(json.dumps(rep.to_dict()))
    out[f"{tag}_lint_events"] = np.array(len(log))


def run_lint_steps(spec, device):
    """The real issue-order logs of two steps on the job's four ranks,
    linted: streaming ZeRO-3 of ``spec["arch"]`` (``spec["layers"]`` of
    its layers) on (4,) ("data",) after a warm-up step, and one TP
    decode step of the same model on ``spec["decode_mesh"]`` (default
    (1, 4)) ("data", "model") after a
    warm-up step (which cuts the rank's slices), ``spec["slots"]`` slots
    in ``spec["max_len"]``-slot rings, the caches its state."""
    from repro_torch.analysis import lint_targets
    from repro_torch.analysis.comm_log import record
    from repro_torch.config.registry import get_arch
    from repro_torch.models.decode_tp import build_decode_step
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import make_slot_caches

    out = {}
    mesh = make_mesh((4,), ("data",), device)
    zspec = dict(spec, full=not spec.get("reduced"),
                 dtype="bf16" if spec.get("bf16") else "f32")
    t = zero3_trainer(zspec, "stream", mesh, device)
    t.init_state(seed=0)
    t.train(1)
    log, step = logged_step(t, mesh)
    lint_out(out, "zero3", log, step, lint_targets.streaming_ctx(
        "zero3_stream", t._fsdp_layout, step.stream,
        t.run.parallel.fsdp_working_set, t.model))
    del t, log, step
    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    model = build_model(cfg, ModelOptions(attn_impl="dense",
                                          dtype=torch.bfloat16))
    params = model.init(0, device)
    mesh = make_mesh(tuple(spec.get("decode_mesh", (1, 4))),
                     ("data", "model"), device)
    slots = spec["slots"]
    step = build_decode_step(model, mesh)
    caches = make_slot_caches(model, slots, spec["max_len"], device)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (slots, 1), generator=gen
                        ).to(device)
    pos = torch.arange(slots, device=device)
    step(params, tok, caches, pos)
    with record(mesh) as log:
        log.mark_state(caches)
        _, caches = step(params, tok, caches, pos + 1)
        log.mark_state(caches, after=True)
    lint_out(out, "decode", log, step, lint_targets.decode_ctx(
        "tp_decode", cfg, slots, mesh))
    return out


def run(job, u0, device, workdir=None):
    out = run_apps(job, device)
    if "tp_full" in job:
        out.update(run_tp_full(job["tp_full"], device))
    if "zero3" in job:
        out.update(run_zero3(job["zero3"], device))
    if "zero3_full" in job:
        out.update(run_zero3_full(job["zero3_full"], device))
    if "gradsync" in job:
        out.update(run_gradsync(job["gradsync"], device))
    if "train" in job:
        out.update(run_train(job["train"], workdir, device))
    if "tp_units" in job:
        out.update(run_tp_units(job["tp_units"], device))
    if "tp_train" in job:
        out.update(run_tp_train(job["tp_train"], workdir, device))
    if "tp_train_full" in job:
        specs = job["tp_train_full"]
        for spec in specs if isinstance(specs, list) else [specs]:
            out.update(run_tp_train_full(spec, workdir, device))
    if "lint_steps" in job:
        out.update(run_lint_steps(job["lint_steps"], device))
    if "tp_elastic" in job:
        out.update(run_tp_elastic(job["tp_elastic"], workdir, device))
    if "serve_cells" in job:
        from _torch_serve import run_serve_cells
        out.update(run_serve_cells(job["serve_cells"], workdir, device))
    if "flash_decode" in job:
        from _torch_serve import run_flash_decode
        out.update(run_flash_decode(job["flash_decode"], device))
    if "serve_full" in job:
        from _torch_serve import run_serve_full
        out.update(run_serve_full(job["serve_full"], workdir, device))
    if "expert_tp_full" in job:
        from _torch_serve import run_expert_tp_full
        out.update(run_expert_tp_full(job["expert_tp_full"], workdir,
                                      device))
    if "iters" not in job:
        return out
    mesh = make_mesh(tuple(job["mesh"]), tuple(job["axes"]), device)
    axes = tuple(job["axes"])
    ut = torch.from_numpy(u0)

    def gathered(block):
        return gather_global(block, mesh, axes, u0.shape).cpu().numpy()

    for mode in ("two_phase", "hdot"):
        u, res = heat2d_solve(ut, mesh, axes, job["iters"], mode, 4,
                              chunk_weights=job.get("chunk_weights"))
        out[f"solve_{mode}"] = gathered(u)
        out[f"res_{mode}"] = res.cpu().numpy()
    if "sweep_tile" in job:
        out["sweep"] = gathered(heat2d_sweep_sharded(
            ut, mesh, axes, tuple(job["sweep_tile"]), job["sweep_sweeps"]))

    # the peeled hdot scan (on its own mesh where the job names one): count
    # its exchanges per axis
    axes = tuple(job.get("scan_axes", job["axes"]))
    if "scan_mesh" in job:
        mesh = make_mesh(tuple(job["scan_mesh"]), axes, device)
    fn = _star if len(axes) == 2 else _sum3
    scan_axes = tuple((a, d) for d, a in enumerate(axes))
    for periodic in (False, True):
        log = _SendLog(mesh)
        halo.dist.batch_isend_irecv = log
        try:
            u, _ = halo.halo_scan_nd(local_block(ut, mesh, axes), fn, mesh,
                                     scan_axes, 1, job["scan_steps"],
                                     periodic, "hdot", 2)
        finally:
            halo.dist.batch_isend_irecv = log._orig
        tag = "periodic" if periodic else "open"
        out[f"scan_{tag}"] = gathered(u)
        out[f"sends_{tag}"] = log.per_axis()
    return out


def spawn(job: dict, u0: np.ndarray, workdir: Path, deadline_s: float):
    """Run `job` on ``prod(job["mesh"])`` ranks, one process each, with a
    FileStore of their own in `workdir` (`u0`: the Heat2D grid, or None for
    a job of the other applications); the whole spawn must finish within
    `deadline_s` or its ranks are killed. Returns each rank's results, or
    raises AssertionError with the failing rank's log."""
    world = int(np.prod(job["mesh"]))
    if u0 is not None:
        np.save(workdir / "u0.npy", u0)
    (workdir / "job.json").write_text(json.dumps(job))
    path = [str(REPO / "src"), str(REPO / "tests")]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   path + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs, logs = [], []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_dist.py"),
             str(workdir), str(r), str(world)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(
                f"rank {r} exited {p.returncode}:\n"
                + (workdir / f"rank{r}.log").read_text()[-4000:])
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def main(argv) -> int:
    workdir, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    job = json.loads((workdir / "job.json").read_text())
    backend = job.get("backend", "gloo")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    u0 = (np.load(workdir / "u0.npy") if (workdir / "u0.npy").exists()
          else None)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = run(job, u0, device, workdir)
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
