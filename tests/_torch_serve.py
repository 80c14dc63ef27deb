"""The serving cells on ranks, for the tests: each rank runs the prefill and
decode cells (``launch/steps.py`` ``build_cell``, ``cell_step``) on its
blocks under ``rules_for(kind)``. Imports no jax; a job of
``tests/_torch_dist.py`` names ``serve_cells`` (reduced models from the
parent's parameters), ``flash_decode`` (the sharded flash-decode alone) or
``serve_full`` (a model at its published widths, on cards) or
``expert_tp_full`` (a MoE model at its published widths whose experts do
not divide the "model" axis, against one card).

A case's parameters come from ``<workdir>/<tag>.npz`` (``leaf<i>`` in tree
order, the parent's float32 numpy draw); its tokens and stub frontend
inputs from :func:`case_inputs`, so the parent makes the same ones.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

# the cases' shapes: b prompts of S tokens, rings of L slots, T decode
# steps teacher-forced from the same tokens (positions S..S+T-1 pass L)
B, S, L, T = 2, 12, 16, 8


def case_cfg(cfg, case):
    """A reduced config of either package with the case's overrides: MoE
    capacity factor ``factor`` (ample, so that expert parallelism's
    per-rank capacity drops nothing and matches one device), expert
    count ``experts`` and encoder frame count ``enc_seq``."""
    moe = {}
    if case.get("factor"):
        moe["capacity_factor"] = case["factor"]
    if case.get("experts"):
        moe["num_experts"] = case["experts"]
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    if case.get("enc_seq"):
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, enc_seq=case["enc_seq"]))
    return cfg


def case_lengths(cfg):
    """(prompt rows, ring slots) of a case: the VLM's patches come first,
    so its prompt and ring are longer by them."""
    extra = cfg.num_vision_patches if cfg.family == "vlm" else 0
    return S + extra, L + extra


def case_inputs(cfg, seed: int = 0) -> dict:
    """The case's numpy inputs: tokens (B, S + T), and the family's stub
    frontend input (float32, normal times 0.02)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, S + T))}
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal(
            (B, cfg.num_vision_patches, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def cells(cfg, opts, b=B, prompt=S, ring=L):
    """(prefill cell, decode cell) of `cfg` for b prompts of `prompt`
    tokens (after the VLM's patches) and `ring`-slot rings."""
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.launch.steps import build_cell

    extra = cfg.num_vision_patches if cfg.family == "vlm" else 0
    pre = build_cell(cfg, ShapeConfig("prefill", prompt + extra, b,
                                      "prefill"), opts)
    dec = build_cell(cfg, ShapeConfig("decode", ring, b, "decode"), opts)
    return pre, dec


def _cut_batch(batch: dict, shardings: dict) -> dict:
    from repro_torch.checkpoint.elastic import cut

    return {k: cut(v, shardings[k]) for k, v in batch.items()}


def _held(tree, shardings) -> tuple:
    """(every leaf of `tree` has its block's shape, the bytes it holds)."""
    from repro_torch.models.layers import tree_leaves

    ok, nbytes = True, 0
    for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        ok &= tuple(x.shape) == tuple(s.stop - s.start for s in sh.index)
        nbytes += x.numel() * x.element_size()
    return ok, nbytes


def _blocks_bytes(shardings, specs) -> int:
    """The bytes of this rank's blocks of the leaves of `specs` (tensors,
    meta ones included) placed by `shardings`."""
    from repro_torch.models.layers import tree_leaves

    return sum(int(np.prod([s.stop - s.start for s in sh.index]))
               * x.element_size() for sh, x in zip(
                   tree_leaves(shardings), tree_leaves(specs)))


def _blocks_equal(a, b) -> bool:
    from repro_torch.models.layers import tree_leaves

    return [s.index for s in tree_leaves(a)] == [
        s.index for s in tree_leaves(b)]


def run_case(case, mesh, device, params_full, inputs) -> dict:
    """One case on the job's mesh: the rank's blocks from `params_full`
    (a whole tree), the prefill cell on this replica's blocks of the
    prompts, the caches re-laid for the decode cell, T decode steps;
    every rank's logits gathered whole. Also: whether each block held is
    its sharding's shape and equal to the whole leaf's slice, the bytes
    held against the blocks' bytes, whether the two cells' blocks
    coincide, and the all-to-alls (all of them, and the MoE blocks'
    dispatches and combines of each cell, ``<tag>_moe_a2a``; each cell's
    whole ``a2a_log``, ``<tag>_cut_log``), flash-decode
    calls and flash kernel launches. ``case["chunks"]`` is the MoE
    all-to-alls' slice count (default 1)."""
    from repro_torch.checkpoint.elastic import cut, unshard_leaf
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import cell_step, relayout
    from repro_torch.models import attention
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions

    cfg = case_cfg(get_arch(case["arch"]).reduced(), case)
    dtype = torch.float32
    opts = ModelOptions(attn_impl="flash", dtype=dtype, scan_layers=False,
                        moe_a2a_chunks=case.get("chunks", 1))
    pre, dec = cells(cfg, opts, ring=case_lengths(cfg)[1])
    ps, ds = cell_step(pre, mesh), cell_step(dec, mesh)
    ps.plan.cut.a2a_log, ds.plan.cut.a2a_log = [], []
    blocks = ps.plan.init_params(params=params_full, device=device)
    tag = case["tag"]
    out = {}
    held, nbytes = _held(blocks, ps.plan.shardings)
    same = all(torch.equal(x, cut(f, sh)) for x, f, sh in zip(
        tree_leaves(blocks), tree_leaves(params_full), ps.plan.shardings))
    out[f"{tag}_param_blocks_ok"] = np.array(held and same)
    out[f"{tag}_param_bytes"] = np.array([nbytes, ps.plan.bytes_at_rest()])
    out[f"{tag}_param_blocks_coincide"] = np.array(
        [s.index for s in ps.plan.shardings]
        == [s.index for s in ds.plan.shardings])

    toks = torch.from_numpy(inputs["tokens"]).to(device)
    full = {"tokens": toks[:, :S]}
    for k in ("frames", "patches"):
        if k in inputs:
            full[k] = torch.from_numpy(inputs[k]).to(device, dtype)
    batch = _cut_batch(full, ps.plan.in_sh[1])
    n0, ring = case_lengths(cfg)
    a2a, orig = [], dist.all_to_all_single
    dist.all_to_all_single = lambda *a, **k: a2a.append(1) or orig(*a, **k)
    flash0 = flash_ops.flash_attention.launches
    fd0 = attention._flash_decode_sharded.calls
    try:
        logits, caches = ps(blocks, batch, max_len=ring)
        out[f"{tag}_prefill_a2a"] = np.array(len(a2a))
        src = ps.plan.cache_shardings(ring)
        dst = dec.in_shardings(mesh)[1]
        out[f"{tag}_cache_blocks_coincide"] = np.array(_blocks_equal(src,
                                                                     dst))
        held, nbytes = _held(caches, src)
        caches = relayout(caches, src, dst, mesh)
        held2, nbytes2 = _held(caches, dst)
        out[f"{tag}_cache_blocks_ok"] = np.array(held and held2)
        out[f"{tag}_cache_bytes"] = np.array([nbytes2, _blocks_bytes(
            dst, dec.arg_specs[1])])
        lsh = _logits_sharding(ps.plan)
        got = [unshard_leaf(logits, lsh, mesh).cpu().numpy()]
        dsh = _logits_sharding(ds.plan)
        blocks = ds.plan.params_from(blocks, ps.plan)
        tsh = ds.plan.in_sh[2]
        for t in range(T):
            lg, caches = ds(blocks, caches,
                            cut(toks[:, S + t:S + t + 1], tsh), n0 + t)
            got.append(unshard_leaf(lg, dsh, mesh).cpu().numpy())
    finally:
        dist.all_to_all_single = orig
    out[f"{tag}_a2a"] = np.array(len(a2a))
    out[f"{tag}_moe_a2a"] = np.array([
        sum(what in ("dispatch", "combine") for what, _ in plan.cut.a2a_log)
        for plan in (ps.plan, ds.plan)])
    out[f"{tag}_cut_log"] = np.array(json.dumps(
        [plan.cut.a2a_log for plan in (ps.plan, ds.plan)]))
    out[f"{tag}_flash_decode_calls"] = np.array(
        attention._flash_decode_sharded.calls - fd0)
    out[f"{tag}_flash"] = np.array(flash_ops.flash_attention.launches
                                   - flash0)
    out[f"{tag}_logits"] = np.concatenate(got, axis=1)
    return out


def _logits_sharding(plan):
    """The Sharding of a cell's (b, 1, V) logits on the plan's mesh."""
    from repro_torch.launch.steps import _sharding

    return _sharding((plan.batch, 1, plan.model.cfg.vocab_size),
                     ("batch", "seq", "vocab"), plan.ctx, plan.mesh)


def load_params(path, cfg, device):
    """A case's whole parameter tree (unrolled, float32) from the parent's
    npz (``leaf<i>`` in tree order)."""
    from repro_torch.models.layers import ParamTree, leaf_paths, rebuild
    from repro_torch.models.model import ModelOptions, build_model

    model = build_model(cfg, ModelOptions(dtype=torch.float32,
                                          scan_layers=False))
    specs = model.param_specs()
    with np.load(path) as z:
        leaves = {p: torch.from_numpy(z[f"leaf{i}"]).to(device)
                  for i, p in enumerate(leaf_paths(specs))}
    return ParamTree(rebuild(specs, leaves))


def run_serve_cells(spec, workdir, device) -> dict:
    """Every case of ``spec["cases"]`` on the job's mesh (:func:`run_case`),
    then, with ``spec["one"]``, each case's logits from ``model.prefill``
    / ``decode_step`` on this rank alone (key ``<tag>_one``)."""
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ModelOptions, build_model

    mesh = make_mesh(tuple(spec["mesh"]), tuple(spec["axes"]), device)
    out = {}
    for case in spec["cases"]:
        cfg = case_cfg(get_arch(case["arch"]).reduced(), case)
        params = load_params(workdir / f"{case['tag']}.npz", cfg, device)
        inputs = case_inputs(cfg, case.get("seed", 0))
        out.update(run_case(case, mesh, device, params, inputs))
        if spec.get("one"):
            model = build_model(cfg, ModelOptions(
                attn_impl="flash", dtype=torch.float32, scan_layers=False))
            out[f"{case['tag']}_one"] = one_rank_logits(model, params,
                                                        inputs, device)
    return out


def one_rank_logits(model, params, inputs, device) -> np.ndarray:
    """``model.prefill`` then T teacher-forced ``decode_step``s on one
    rank: the (B, 1 + T, V) logits."""
    cfg = model.cfg
    toks = torch.from_numpy(inputs["tokens"]).to(device)
    batch = {"tokens": toks[:, :S]}
    for k in ("frames", "patches"):
        if k in inputs:
            batch[k] = torch.from_numpy(inputs[k]).to(device,
                                                      model.opt.dtype)
    n0, ring = case_lengths(cfg)
    with torch.no_grad():
        lg, caches = model.prefill(params, batch, max_len=ring)
        got = [lg.cpu().numpy()]
        for t in range(T):
            lg, caches = model.decode_step(params, toks[:, S + t:S + t + 1],
                                           caches, n0 + t)
            got.append(lg.cpu().numpy())
    return np.concatenate(got, axis=1)


# -------------------------------------------------- the flash-decode alone
FD = dict(b=4, w=64, steps=48, seed=1)


def flash_decode_inputs(cfg):
    """(attention params, x sequence) of the flash-decode job: numpy
    float32, the leaves normal / sqrt(fan_in), x normal times 0.1."""
    rng = np.random.default_rng(FD["seed"])
    hd = cfg.resolved_head_dim
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    p = {"wq": draw(d, h, hd), "wk": draw(d, kv, hd), "wv": draw(d, kv, hd),
         "wo": draw(h, hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = np.ones(hd, np.float32)
        p["k_norm"] = np.ones(hd, np.float32)
    x = (rng.standard_normal((FD["b"], FD["steps"], d)) * 0.1).astype(
        np.float32)
    return p, x


def flash_decode_cfg():
    from repro_torch.config.registry import get_arch

    return dataclasses.replace(get_arch("qwen3-8b").reduced(), num_layers=1)


def run_flash_decode(spec, device) -> dict:
    """The sharded flash-decode over the job's ranks (each holding a
    block of a ``w``-slot ring), for each window of ``spec["windows"]``:
    ``decode_attention`` at positions 0..steps-1 with a ``Ring``; its
    outputs, and the largest difference from ``_decode_dense`` over the
    all-gathered ring at each step (the same projections). Records, per
    step, whether this rank saw no visible slot."""
    from repro_torch.models import attention as attn
    from repro_torch.sharding.tp import Ring, gather_dim

    cfg = flash_decode_cfg()
    p_np, x_np = flash_decode_inputs(cfg)
    p = {k: torch.from_numpy(v).to(device) for k, v in p_np.items()}
    x = torch.from_numpy(x_np).to(device)
    n, r = dist.get_world_size(), dist.get_rank()
    w, b = FD["w"], FD["b"]
    size = w // n
    ring = Ring(w, ("model",), r * size, size, (), dist.group.WORLD)
    out = {}
    for window in spec["windows"]:
        tag = f"w{window}"
        cache = attn.make_cache(cfg, b, size, torch.float32, device)
        cache["pos"].fill_(-1)
        ys, gap, blind = [], 0.0, []
        for t in range(x.shape[1]):
            y, cache = attn.decode_attention(p, x[:, t:t + 1], cfg, cache, t,
                                             window=window, ring=ring)
            ys.append(y)
            seen = ((cache["pos"] >= 0) & (cache["pos"] <= t))
            if window is not None:
                seen &= cache["pos"] > t - window
            blind.append(int(not bool(seen.any())))
            whole = {k: gather_dim(v, 1 if k != "pos" else 0,
                                   dist.group.WORLD, list(range(n)))
                     for k, v in cache.items()}
            positions = torch.full((b, 1), t, dtype=torch.int64,
                                   device=device)
            q = attn.project_q(p, x[:, t:t + 1], cfg, positions)
            k, v = attn.project_kv(p, x[:, t:t + 1], cfg, positions)
            dense, _ = attn._decode_dense(q, k, v, whole, t, positions,
                                          window)
            dense = torch.einsum("bshk,hkd->bsd", dense, p["wo"])
            gap = max(gap, float((y - dense).abs().max()))
        out[f"fd_{tag}_y"] = torch.cat(ys, dim=1).cpu().numpy()
        out[f"fd_{tag}_vs_dense"] = np.array(gap)
        out[f"fd_{tag}_blind"] = np.array(blind)
    return out


# ------------------------------------------------ a model at full width
def run_serve_full(spec, workdir, device) -> dict:
    """A model at its published widths served through the cells on the
    job's mesh: bf16, unrolled, each leaf drawn from seed 0 and cut before
    the next (peak memory during init recorded), the prefill cell on
    ``spec["batch"]`` prompts of ``spec["prompt"]`` tokens (numpy seed 0)
    into ``spec["ring"]``-slot rings, then ``spec["steps"]`` decode steps
    at a scalar position (greedy on the gathered logits; rank 0's ids are
    broadcast). Records the bytes allocated at rest against the blocks,
    every card's peak, prefill tokens/s, each decode step's time, the
    all-to-alls and flash-decode calls a step, the flash launches, and
    one decode step traced on every rank (``nccl_exposure``, the host ops
    with the most self time, the CUDA runtime calls made 32 times or
    more). With
    ``spec["check"]``, first a 2-layer cut of the model at the same
    widths in float32 runs through the same cells and, on every rank,
    against ``model.prefill`` / ``decode_step`` on its own card with the
    same parameters (and the flash-decode against ``_decode_dense`` over
    the gathered ring)."""
    from torch.profiler import ProfilerActivity, profile

    from _torch_dist import nccl_exposure
    from repro_torch.checkpoint.elastic import unshard_leaf
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import cell_step, relayout
    from repro_torch.models import attention
    from repro_torch.models.model import ModelOptions

    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"), device)
    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):     # a rehearsal of the job on the CPU
        cfg = cfg.reduced()
    out = {}
    if spec.get("check"):
        out.update(full_width_check(cfg, spec, mesh, device))
        _empty_cache(device)
    b, s, ring, steps = (spec["batch"], spec["prompt"], spec["ring"],
                         spec["steps"])
    opts = ModelOptions(attn_impl="flash", dtype=torch.bfloat16,
                        scan_layers=False)
    pre, dec = cells(cfg, opts, b, s, ring)
    _sync(device)
    _reset_peak(device)
    base = _allocated(device)
    ps, ds = cell_step(pre, mesh), cell_step(dec, mesh)
    t0 = time.perf_counter()
    blocks = ps.plan.init_params(seed=0, device=device)
    _sync(device)
    out["init_s"] = np.array(time.perf_counter() - t0)
    out["params_at_rest"] = np.array(_allocated(device)
                                     - base)
    out["params_blocks"] = np.array(ps.plan.bytes_at_rest())
    out["init_peak"] = np.array(_peak(device)
                                - base)
    out["param_blocks_coincide"] = np.array(
        [x.index for x in ps.plan.shardings]
        == [x.index for x in ds.plan.shardings])
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s))).to(
        device)
    batch = {"tokens": toks}
    batch = _cut_batch(batch, ps.plan.in_sh[1])
    ps(blocks, batch, max_len=ring)        # warm-up (kernel build, NCCL)
    _empty_cache(device)
    a2a, orig = [], dist.all_to_all_single
    dist.all_to_all_single = lambda *a, **k: a2a.append(1) or orig(*a, **k)
    flash0 = flash_ops.flash_attention.launches
    try:
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = ps(blocks, batch, max_len=ring)
        _sync(device)
        out["prefill_s"] = np.array(time.perf_counter() - t0)
        out["prefill_a2a"] = np.array(len(a2a))
        out["flash"] = np.array(flash_ops.flash_attention.launches - flash0)
        src = ps.plan.cache_shardings(ring)
        dst = dec.in_shardings(mesh)[1]
        out["cache_blocks_coincide"] = np.array(_blocks_equal(src, dst))
        caches = relayout(caches, src, dst, mesh)
        out["caches_at_rest"] = np.array(sum(
            x.numel() * x.element_size()
            for x in _tensor_leaves(caches)))
        out["cache_blocks"] = np.array(_blocks_bytes(dst, dec.arg_specs[1]))
        lsh = _logits_sharding(ds.plan)
        psh = _logits_sharding(ps.plan)
        nxt = _greedy(unshard_leaf(logits, psh, mesh))
        times, ids = [], [nxt.cpu()]
        a2a.clear()
        fd0 = attention._flash_decode_sharded.calls
        for t in range(steps):
            _sync(device)
            t1 = time.perf_counter()
            lg, caches = ds(blocks, caches, nxt, s + t)
            _sync(device)
            times.append(time.perf_counter() - t1)
            nxt = _greedy(unshard_leaf(lg, lsh, mesh))
            ids.append(nxt.cpu())
        out["decode_a2a"] = np.array(len(a2a))
        out["flash_decode_calls"] = np.array(
            attention._flash_decode_sharded.calls - fd0)
    finally:
        dist.all_to_all_single = orig
    out["step_s"] = np.array(times)
    out["ids"] = torch.cat(ids, dim=1).numpy()
    out["finite"] = np.array(bool(torch.isfinite(lg).all()))
    out["peak"] = np.array(_peak(device))
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ds(blocks, caches, nxt, s + steps)
        _sync(device)
        out["traced_s"] = np.array(time.perf_counter() - t1)
    for k, v in nccl_exposure(prof).items():
        out[k] = np.array(v)
    avg = prof.key_averages()
    host = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:8]
    out["host_top"] = np.array(json.dumps(
        [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in host]))
    out["runtime_calls"] = np.array(json.dumps(
        {e.key: [e.count, e.self_cpu_time_total / 1e3] for e in avg
         if e.key.startswith("cuda") and e.count >= 32}))
    return out


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device):
    if _cuda(device):
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) if _cuda(device) else 0


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if _cuda(device) else 0


def _empty_cache(device):
    if _cuda(device):
        torch.cuda.empty_cache()


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax ids (b, 1) of whole logits, rank 0's on every rank."""
    ids = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    if dist.is_initialized():
        dist.broadcast(ids, 0)
    return ids


def full_width_check(cfg, spec, mesh, device) -> dict:
    """The 2-layer cut of `cfg` at its widths, float32, through the cells
    on `mesh` against ``model.prefill`` / ``decode_step`` on this card
    with the same parameters (seed 0): the largest logit difference over
    the prefill and ``spec["check_steps"]`` decode steps past the ring's
    wrap of its ``check_ring``-slot rings, and the logits' scale."""
    from repro_torch.checkpoint.elastic import unshard_leaf
    from repro_torch.launch.steps import cell_step, relayout
    from repro_torch.models.model import ModelOptions, build_model

    cfg = dataclasses.replace(cfg, num_layers=2)
    if cfg.moe is not None and spec.get("check_factor"):
        cfg = case_cfg(cfg, {"factor": spec["check_factor"]})
    b, s, ring, steps = (spec["batch"], spec["check_prompt"],
                         spec["check_ring"], spec["check_steps"])
    opts = ModelOptions(attn_impl="flash", dtype=torch.float32,
                        scan_layers=False)
    model = build_model(cfg, opts)
    pre, dec = cells(cfg, opts, b, s, ring)
    ps, ds = cell_step(pre, mesh), cell_step(dec, mesh)
    params = model.init(0, device)
    blocks = ps.plan.init_params(params=params, device=device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (b, s + steps))).to(device)
    with torch.no_grad():
        want, wc = model.prefill(params, {"tokens": toks[:, :s]},
                                 max_len=ring)
    got, caches = ps(blocks, _cut_batch({"tokens": toks[:, :s]},
                                        ps.plan.in_sh[1]), max_len=ring)
    psh, lsh = _logits_sharding(ps.plan), _logits_sharding(ds.plan)
    diff = [float((unshard_leaf(got, psh, mesh) - want).abs().max())]
    caches = relayout(caches, ps.plan.cache_shardings(ring),
                      dec.in_shardings(mesh)[1], mesh)
    for t in range(steps):
        tok = toks[:, s + t:s + t + 1]
        with torch.no_grad():
            want, wc = model.decode_step(params, tok, wc, s + t)
        got, caches = ds(blocks, caches, tok, s + t)
        diff.append(float((unshard_leaf(got, lsh, mesh) - want).abs().max()))
    scale = float(want.abs().max())
    return {"check_max_abs": np.array(diff), "check_logit_scale":
            np.array(scale)}


def run_expert_tp_full(spec, workdir, device) -> dict:
    """``spec["arch"]`` (a MoE model) at its published widths, cut to
    ``spec["layers"]`` layers and ``spec["experts"]`` experts (so that the
    job's "model" ranks do not divide them: expert TP), bf16, unrolled,
    served through the cells on the job's ("data", "model") mesh: each
    leaf drawn from seed 0 and cut before the next; ``spec["batch"]``
    prompts of ``spec["prompt"]`` tokens (numpy seed 2) into
    ``spec["ring"]``-slot rings, then ``spec["steps"]`` decode steps
    teacher-forced from the same draw; every step's logits gathered whole.
    Then, on this rank's own card, the same parameters whole
    (``model.init(0)``) through ``model.prefill`` / ``decode_step`` on the
    same tokens: the mean and largest absolute logit difference of each
    step. Records the bytes allocated at rest against the blocks, whether
    each block held has its sharding's shape, and the expert count each
    expert leaf holds."""
    from repro_torch.checkpoint.elastic import cut, unshard_leaf
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import cell_step, relayout
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import ModelOptions, build_model

    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"), device)
    cfg = get_arch(spec["arch"])
    if spec.get("reduced"):     # a rehearsal of the job on the CPU
        cfg = cfg.reduced()
    cfg = dataclasses.replace(
        cfg, num_layers=spec["layers"],
        moe=dataclasses.replace(cfg.moe, num_experts=spec["experts"]))
    b, s, ring, steps = (spec["batch"], spec["prompt"], spec["ring"],
                         spec["steps"])
    opts = ModelOptions(attn_impl="flash", dtype=torch.bfloat16,
                        scan_layers=False)
    pre, dec = cells(cfg, opts, b, s, ring)
    ps, ds = cell_step(pre, mesh), cell_step(dec, mesh)
    out = {"experts_placed": np.array([ps.plan.cut.experts,
                                       ps.plan.cut.expert_cols,
                                       ds.plan.cut.experts,
                                       ds.plan.cut.expert_cols])}
    _sync(device)
    base = _allocated(device)
    blocks = ps.plan.init_params(seed=0, device=device)
    _sync(device)
    out["params_at_rest"] = np.array(_allocated(device) - base)
    out["params_blocks"] = np.array(ps.plan.bytes_at_rest())
    out["param_blocks_ok"] = np.array(_held(blocks, ps.plan.shardings)[0])
    out["expert_leaf_experts"] = np.array([
        x.shape[0] for path, x in zip(ps.plan.paths, tree_leaves(blocks))
        if path[-2:-1] == ("moe",) and path[-1] != "router"])
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (b, s + steps))).to(device)
    logits, caches = ps(blocks, _cut_batch({"tokens": toks[:, :s]},
                                           ps.plan.in_sh[1]), max_len=ring)
    psh, lsh = _logits_sharding(ps.plan), _logits_sharding(ds.plan)
    got = [unshard_leaf(logits, psh, mesh)]
    caches = relayout(caches, ps.plan.cache_shardings(ring),
                      dec.in_shardings(mesh)[1], mesh)
    blocks = ds.plan.params_from(blocks, ps.plan)
    tsh = ds.plan.in_sh[2]
    for t in range(steps):
        lg, caches = ds(blocks, caches, cut(toks[:, s + t:s + t + 1], tsh),
                        s + t)
        got.append(unshard_leaf(lg, lsh, mesh))
    del blocks, caches
    _empty_cache(device)
    model = build_model(cfg, opts)
    params = model.init(0, device)
    with torch.no_grad():
        want, wc = model.prefill(params, {"tokens": toks[:, :s]},
                                 max_len=ring)
        diffs = [(got[0].float() - want.float()).abs()]
        for t in range(steps):
            want, wc = model.decode_step(params, toks[:, s + t:s + t + 1],
                                         wc, s + t)
            diffs.append((got[t + 1].float() - want.float()).abs())
    out["logit_mean_abs"] = np.array([float(d.mean()) for d in diffs])
    out["logit_max_abs"] = np.array([float(d.max()) for d in diffs])
    out["finite"] = np.array(all(bool(torch.isfinite(g).all()) for g in got))
    del params, wc
    _empty_cache(device)
    return out
