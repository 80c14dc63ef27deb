"""Targets of the schedule linter: the port of ``repro/analysis/
lint_targets.py``.

Each target runs one of the port's programs (the stencil solvers, the raw
halo scans, the explicit grad-sync schedules, the LM train steps: DP with
HDOT buckets, ZeRO-3 gathering all and streaming, tensor-parallel; the MoE
EP layer; the TP decode step) once, for rank 0 of a fake process group of
4 or 8 ranks, on small real tensors, records its issue-order log
(``analysis/comm_log.py``) and pairs it with a :class:`LintContext` whose
expectations come from the schedule code the port runs (``make_buckets``
and ``FsdpLayout`` element counts, the halo arithmetic for rank 0's
neighbours, ``decode_tp.expected_permute_total``, the TP plan's
gathers). Nothing is sent: the fake group records the calls, so a
received buffer keeps what it held; no rule reads values.

``BROKEN`` holds the mutations: mis-scheduled variants that must trip
their rules (``TRIPS``) and no other; the ones the port's code has no option
for (the unpeeled drain, the TP step's old gather-all) are written here,
not in the code they mutate. ``all_targets()`` lists the canonical set.

Counts are rank 0's. A periodic axis gives it two neighbours (one peer,
sent to twice, on an axis of 2), so its sends match the JAX package's
permute counts (``2·axes·steps``); a non-periodic axis (Heat2D, HPCCG)
gives it one, and half of them.
"""
from __future__ import annotations

import math
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.comm_log import CommLog, hlo_dtype, record
from repro_torch.analysis.rules import LintContext


@dataclass
class Target:
    name: str
    log: CommLog
    ctx: LintContext


TARGETS: Dict[str, Callable[..., Target]] = {}
BROKEN: Dict[str, Callable[..., Target]] = {}
# the rules each broken target must trip (and no other)
TRIPS: Dict[str, Tuple[str, ...]] = {}
# the fake group each target runs on
RANKS: Dict[str, int] = {}


def _register(name: str, registry: Dict, ranks: int, trips=()):
    def deco(fn):
        registry[name] = fn
        RANKS[name] = ranks
        if trips:
            TRIPS[name] = tuple(trips)
        return fn
    return deco


def target(name: str, ranks: int = 4):
    return _register(name, TARGETS, ranks)


def broken(name: str, trips, ranks: int = 4):
    return _register(name, BROKEN, ranks, trips)


def all_targets() -> List[str]:
    return list(TARGETS)


def broken_targets() -> List[str]:
    return list(BROKEN)


def describe(broken: bool = False) -> List[Tuple[str, str]]:
    reg = BROKEN if broken else TARGETS
    return [(n, (fn.__doc__ or "").strip().splitlines()[0])
            for n, fn in reg.items()]


def build(name: str, device: str = "cpu", ranks: int = 8) -> Target:
    """Run target `name` on rank 0 of a fake group of its ranks (at most
    `ranks`) with tensors on `device`. A fake group this call started is
    destroyed after it."""
    from repro_torch.launch.dryrun import fake_group

    fn = TARGETS.get(name) or BROKEN.get(name)
    if fn is None:
        raise KeyError(f"unknown lint target {name!r}; known: "
                       f"{', '.join([*TARGETS, *BROKEN])}")
    n = RANKS[name]
    if n > ranks:
        raise SystemExit(f"target {name!r} runs on {n} ranks, more than "
                         f"--ranks {ranks}")
    started = not dist.is_initialized()
    fake_group(n)
    try:
        torch.manual_seed(0)
        tgt = fn(device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return tgt


def _run(mesh, step: Callable, state=None) -> CommLog:
    """Log one call of ``step()`` on `mesh`. With `state`, `step` returns
    ``(new_state, outputs)`` and the log holds the storages of both
    states; else it returns its outputs."""
    with record(mesh) as log:
        if state is None:
            log.mark_outputs(step())
        else:
            log.mark_state(state)
            new, out = step()
            log.mark_state(new, after=True)
            log.mark_outputs((new, out))
    return log


# ---------------------------------------------------------- halo arithmetic
def halo_sends(mesh, axes, exchanges: int, periodic: bool
               ) -> Dict[str, int]:
    """Rank 0's sends per axis for `exchanges` exchanges on each axis of
    `axes`: one to each neighbour it has (``mesh.neighbors``)."""
    out = {}
    for a in axes:
        if mesh.shape[a] == 1:
            continue
        out[a] = exchanges * sum(p is not None
                                 for p in mesh.neighbors(a, periodic))
    return out


def halo_events(mesh, axes, exchanges: int, periodic: bool) -> int:
    """Rank 0's sends and receives of `exchanges` exchanges on each axis."""
    return 2 * sum(halo_sends(mesh, axes, exchanges, periodic).values())


def _ctx_sends(name: str, sends: Dict[str, int], **kw) -> LintContext:
    return LintContext(target=name, expected_permutes=sends,
                       expected_permute_total=sum(sends.values()), **kw)


# ------------------------------------------------------------- halo scans
_STEPS = 2


def _avg3(p):
    return (p[:-2] + p[1:-1] + p[2:]) / 3.0


def _star(p):
    return (p[1:-1, 1:-1] + p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2]
            + p[1:-1, 2:]) / 5.0


def _star3(p):
    return (p[1:-1, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2]
            + p[1:-1, 1:-1, 2:]) / 7.0


def _halo_setup(ndim: int, device):
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh

    if ndim == 1:
        mesh = make_mesh((4,), ("data",), device)
        return mesh, (("data", 0),), _avg3, (16, 4), (4,)
    if ndim == 2:
        mesh = make_grid_mesh(2, 2, device=device)
        return mesh, (("rows", 0), ("cols", 1)), _star, (8, 8), (2, 2)
    mesh = make_grid_mesh(2, 2, 2, device=device)
    axes = ("planes", "rows", "cols")
    return mesh, tuple(zip(axes, (0, 1, 2))), _star3, (8, 8, 8), (2, 2, 2)


def _unpeeled_scan(u, fn, mesh, axes, steps, subdomains):
    """A 1-D halo scan whose last step still sends: the drain exchange the
    peeled scan (``core.halo.halo_scan_nd``) drops, whose halos no step
    reads. Written here as a mutation; the port's scan has no such
    option."""
    from repro_torch.core import halo

    ((a, d),) = axes
    pending = halo._start_halo_nd(u, mesh, axes, 1, True)
    for _ in range(steps):
        halos = [p.wait() for p in pending]
        faces = halo._faces_nd(u, halos, fn, 1, (d,))
        pending = [halo.start_exchange(*faces[0], mesh, a, True)]
        interior = halo._interior_chunks_nd(u, fn, 1, (d,), subdomains,
                                            None)
        u = halo._assemble_nd(faces, interior, (d,))
    return u


def _halo_target(name: str, ndim: int, device, peel: bool = True,
                 donate: bool = True) -> Target:
    """The scan of `ndim` axes, periodic, its step writing its result into
    its state (the counterpart of the reference's donated jit) unless
    `donate` is off."""
    from repro_torch.core.halo import halo_scan_nd

    mesh, axes, fn, shape, subn = _halo_setup(ndim, device)
    u = torch.randn(shape, device=mesh.device)

    def step():
        if peel:
            out = halo_scan_nd(u, fn, mesh, axes, 1, _STEPS, periodic=True,
                               subdomains=subn)[0]
        else:
            out = _unpeeled_scan(u, fn, mesh, axes, _STEPS, subn)
        if donate:
            return u.copy_(out), None
        return out, None

    names = [a for a, _ in axes]
    ctx = _ctx_sends(name, halo_sends(mesh, names, _STEPS, True),
                     expect_donation=True,
                     # the pipeline fill: step 0 waits on it at once
                     max_exposed_collectives=halo_events(mesh, names, 1,
                                                         True))
    return Target(name, _run(mesh, step, u), ctx)


@target("halo1d")
def _halo1d(device) -> Target:
    """halo_scan_nd, 1-D ring of 4, steps=2 peeled, state updated in place."""
    return _halo_target("halo1d", 1, device)


@target("halo2d")
def _halo2d(device) -> Target:
    """halo_scan_nd on a 2x2 mesh, steps=2 peeled, state updated in place."""
    return _halo_target("halo2d", 2, device)


@target("halo3d", ranks=8)
def _halo3d(device) -> Target:
    """halo_scan_nd on a 2x2x2 mesh, steps=2 peeled, state updated in place."""
    return _halo_target("halo3d", 3, device)


# --------------------------------------------------------------- solvers
def _heat2d_target(name: str, device, grid, mesh_shape, weights=None,
                   mode: str = "hdot") -> Target:
    from repro_torch.core.stencil import heat2d_solve
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh

    if len(mesh_shape) == 1:
        mesh, axes = make_mesh(mesh_shape, ("data",), device), ("data",)
    else:
        mesh, axes = make_grid_mesh(*mesh_shape, device=device), \
            ("rows", "cols")
    u0 = torch.rand(grid, device=mesh.device)
    log = _run(mesh, lambda: heat2d_solve(u0, mesh, axes, _STEPS, mode,
                                          4 if len(axes) == 1 else (2, 2),
                                          weights))
    ctx = _ctx_sends(name, halo_sends(mesh, axes, _STEPS, False),
                     max_exposed_collectives=halo_events(mesh, axes, 1,
                                                         False))
    return Target(name, log, ctx)


@target("heat2d_1d")
def _heat2d_1d(device) -> Target:
    """heat2d Jacobi sweeps, 1-D slab decomposition over 4 ranks."""
    return _heat2d_target("heat2d_1d", device, (32, 32), (4,))


@target("heat2d_2d")
def _heat2d_2d(device) -> Target:
    """heat2d with 2-D (rows x cols) block decomposition on 2x2."""
    return _heat2d_target("heat2d_2d", device, (32, 32), (2, 2))


@target("heat2d_weighted")
def _heat2d_weighted(device) -> Target:
    """heat2d hdot with a measured-cost WEIGHTED (uneven) interior re-cut on
    2x2: the face messages must be the uniform cut's (local 16x18 block,
    interior 14x16 cut (5, 9) x (7, 9))."""
    return _heat2d_target("heat2d_weighted", device, (32, 36), (2, 2),
                          ((5, 9), (7, 9)))


def _rk3_target(name: str, device, grid, mesh_shape) -> Target:
    from repro_torch.core.stencil import rk3_solve
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh

    if len(mesh_shape) == 1:
        mesh, axes = make_mesh(mesh_shape, ("data",), device), ("data",)
    else:
        mesh, axes = make_grid_mesh(*mesh_shape, device=device), \
            ("rows", "cols")
    v0 = torch.rand(grid, device=mesh.device)
    log = _run(mesh, lambda: rk3_solve(v0, mesh, axes, _STEPS, 0.01))
    # 3 stage exchanges a step on each axis: one fill, 3 a full step, 2 in
    # the peeled last step; each waits behind the next stage's local work
    return Target(name, log, _ctx_sends(
        name, halo_sends(mesh, axes, 3 * _STEPS, True)))


@target("rk3_1d")
def _rk3_1d(device) -> Target:
    """RK3 advection, z-slab decomposition over 4 ranks, steps=2."""
    # a 16-cell z block: the pipelined stage-carried path
    return _rk3_target("rk3_1d", device, (12, 16, 64), (4,))


@target("rk3_2d")
def _rk3_2d(device) -> Target:
    """RK3 on a (y, z) 2x2 grid mesh, stage-carried halos on both axes."""
    return _rk3_target("rk3_2d", device, (12, 32, 32), (2, 2))


def _hpccg_target(name: str, device, mesh_shape) -> Target:
    from repro_torch.core.stencil import hpccg_solve
    from repro_torch.launch.mesh import make_grid_mesh, make_mesh

    if len(mesh_shape) == 1:
        mesh, axes = make_mesh(mesh_shape, ("data",), device), ("data",)
    else:
        mesh = make_grid_mesh(*mesh_shape, device=device)
        axes = ("planes", "rows", "cols")
    b = torch.rand((12, 20, 20), device=mesh.device)
    log = _run(mesh, lambda: hpccg_solve(b, mesh, axes, _STEPS, "hdot", 4))
    # one exchange chain an iteration; the chain's earlier axes pad in
    # order (each exchange waited at once), only the last axis's flies
    # behind the matvec's interior chunks
    return Target(name, log, _ctx_sends(
        name, halo_sends(mesh, axes, _STEPS, False),
        max_exposed_collectives=halo_events(mesh, axes[:-1], _STEPS,
                                            False)))


@target("hpccg_1d")
def _hpccg_1d(device) -> Target:
    """HPCCG CG iterations, 1-D decomposition over 4 ranks, iters=2."""
    return _hpccg_target("hpccg_1d", device, (4,))


@target("hpccg_3d", ranks=8)
def _hpccg_3d(device) -> Target:
    """HPCCG on a 2x2x2 (planes x rows x cols) mesh, iters=2."""
    return _hpccg_target("hpccg_3d", device, (2, 2, 2))


# ------------------------------------------------------------- grad sync
SYNC_TREE_SIZES = {"embed": 11, "w1": 23, "w2": 37, "head": 53}
SYNC_TREE_LAYERS = {"embed": 0, "w1": 1, "w2": 2, "head": 3}


def grad_sync_expected(order: str) -> List[int]:
    """Per-leaf all-reduce elements in issue order, from make_buckets."""
    from repro_torch.core.overlap import make_buckets

    tree = {k: torch.zeros(n) for k, n in SYNC_TREE_SIZES.items()}
    return [leaf.numel() for b in make_buckets(
        tree, 4, layers=SYNC_TREE_LAYERS, order=order) for _, leaf in b]


def _grad_sync_target(name: str, device, order: str = "reverse_topo",
                      mode: str = "hdot", tree=None) -> Target:
    from repro_torch.core.overlap import grad_sync
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), device)
    if tree is None:
        tree = {k: torch.randn(n, device=mesh.device)
                for k, n in SYNC_TREE_SIZES.items()}
    log = _run(mesh, lambda: grad_sync(tree, mesh, ("data",), mode=mode,
                                       num_buckets=4,
                                       layers=SYNC_TREE_LAYERS, order=order))
    ctx = LintContext(target=name, expected_permute_total=0,
                      expected_ar_elements=grad_sync_expected(
                          "reverse_topo"),
                      wire_dtype_elements={
                          "f32": sum(SYNC_TREE_SIZES.values())})
    return Target(name, log, ctx)


@target("grad_sync_1d")
def _grad_sync_1d(device) -> Target:
    """Explicit HDOT grad sync: per-bucket all-reduces, reverse-topo issue."""
    return _grad_sync_target("grad_sync_1d", device)


# ------------------------------------------------------------ LM steps
def _trainer(parallel, mesh_shape, axes, device, options=None,
             arch: str = "qwen3-8b"):
    from repro_torch.config.base import RunConfig, TrainConfig
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import Trainer

    cfg = get_arch(arch).reduced()
    train = TrainConfig(global_batch=8, seq_len=32, warmup_steps=2,
                        total_steps=10, checkpoint_every=10**6,
                        checkpoint_dir=tempfile.gettempdir())
    mesh = make_mesh(mesh_shape, axes, device)
    t = Trainer(RunConfig(cfg, parallel, train), mesh=mesh, options=options)
    t.init_state()
    return t, mesh


def _train_log(t, step=None, sink: bool = False) -> CommLog:
    """One logged step of trainer `t` (its own step unless `step`),
    params and moments as the state."""
    batch = t._place_batch(0)
    with record(t.mesh) as log:
        if sink:
            t.fsdp_log = log.fsdp_sink()
        fn = step or t._build_step()
        state = (t.params, t.opt_state)
        log.mark_state(state)
        params, opt, metrics = fn(t.params, t.opt_state, batch)
        log.mark_state((params, opt), after=True)
        log.mark_outputs((params, opt, metrics))
    log.step = fn
    return log


def param_budget(model) -> Dict[str, int]:
    """The parameter spec's elements per wire dtype (HLO names)."""
    from repro_torch.models.layers import tree_leaves

    out: Dict[str, int] = {}
    for s in tree_leaves(model.param_specs()):
        dt = hlo_dtype(s.dtype)
        out[dt] = out.get(dt, 0) + math.prod(s.shape)
    return out


def _lm_hdot_target(name: str, mesh_shape, axes, device) -> Target:
    from repro_torch.config.base import ParallelConfig

    par = ParallelConfig(param_shard=False, remat="none", overlap="hdot",
                         dp_axes=tuple(axes))
    t, _ = _trainer(par, mesh_shape, axes, device)
    log = _train_log(t)
    # the bucket that completes last in the backward (the embedding's) is
    # issued after the last backward op and waited at once: one all-reduce
    # a flat buffer (a dtype) of it
    ctx = LintContext(target=name, expected_permute_total=0,
                      wire_dtype_elements=param_budget(t.model),
                      expect_donation=True,
                      max_exposed_collectives=len(log.step.buckets.flats[-1]))
    return Target(name, log, ctx)


@target("lm_hdot_1d")
def _lm_hdot_1d(device) -> Target:
    """lm train step, explicit HDOT bucketed grad sync, 4-way DP."""
    return _lm_hdot_target("lm_hdot_1d", (4,), ("data",), device)


@target("lm_hdot_2d")
def _lm_hdot_2d(device) -> Target:
    """lm train step, HDOT grad sync over a 2-D (pod x data) DP mesh."""
    return _lm_hdot_target("lm_hdot_2d", (2, 2), ("pod", "data"), device)


def _fsdp_budget(layout) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for g in layout.groups:
        dt = hlo_dtype(getattr(torch, g.dtype))
        out[dt] = out.get(dt, 0) + g.padded // layout.n_shards
    return out


@target("lm_fsdp_1d")
def _lm_fsdp_1d(device) -> Target:
    """lm FSDP (ZeRO-3) step: one RS + one AG per bucket, reverse issue."""
    from repro_torch.config.base import ParallelConfig

    par = ParallelConfig(param_shard=True, remat="none")
    t, _ = _trainer(par, (4,), ("data",), device)
    log = _train_log(t, sink=True)
    layout = t._fsdp_layout
    n = layout.n_shards
    ctx = LintContext(
        target="lm_fsdp_1d", expected_permute_total=0,
        expected_rs_elements=[g.padded // n for g in reversed(layout.groups)],
        expected_ag_elements=[g.padded for g in layout.groups],
        wire_dtype_elements=_fsdp_budget(layout), expect_donation=True,
        # gathering all issues every gather before the forward and every
        # reduce-scatter after the backward: nothing runs in their windows
        max_exposed_collectives=2 * len(layout.groups))
    return Target("lm_fsdp_1d", log, ctx)


def _streaming_pieces(streaming: bool, device):
    """The streaming target and its gather-all mutation: the same
    per-layer layout and model options; only the gather placement differs
    (inside each consuming layer's remat region, or all at the top)."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.models.model import ModelOptions

    par = ParallelConfig(param_shard=True, fsdp_streaming=streaming,
                         scan_layers=False, remat="full",
                         bucket_order="layer")
    opts = ModelOptions(attn_impl="dense", scan_layers=False, remat="full",
                        fused_xent=False)
    t, _ = _trainer(par, (4,), ("data",), device, options=opts)
    log = _train_log(t, sink=True)
    return t, log, par


def _per_depth(layout, model) -> int:
    from repro_torch.models.layers import tree_leaves

    tags = tree_leaves(model.param_layers())
    per: Dict[int, int] = {}
    for g in layout.groups:
        d = int(tags[g.leaf_idx[0]])
        per[d] = per.get(d, 0) + 1
    return max(per.values())


def streaming_ctx(name: str, layout, stream, working_set: int,
                  model) -> LintContext:
    """The expectations of one streaming ZeRO-3 step (``FsdpStream``
    `stream` over `layout`, `model`'s depths), from the schedule itself."""
    n = layout.n_shards
    fwd = [g.padded for g in layout.groups]
    # the backward regathers every LAYER depth in reverse layer order; the
    # embedding and head buffers gather once (models.model.
    # train_loss_streamed)
    layer_depths = [d for d in stream.depths
                    if d not in (0, max(stream.depths))]
    bwd = [g.padded for d in reversed(layer_depths)
           for g in stream.groups_at(d)]
    # reduce-scatters as the backward reaches each depth's gathers, the
    # head's first, the embedding's last; within a depth in reversed
    # layout order, as grad_sync_fsdp issues them
    rs = [g.padded // n for d in reversed(stream.depths)
          for g in reversed(stream.groups_at(d))]
    per = _per_depth(layout, model)
    return LintContext(
        target=name, expected_permute_total=0,
        expected_rs_elements=rs, expected_ag_elements=fwd + bwd,
        wire_dtype_elements=_fsdp_budget(layout), expect_donation=True,
        # the first gather of each direction (the embedding's forward, the
        # last layer's backward regather: nothing runs before them) and
        # the embedding's reduce-scatter, issued after the last backward op
        max_exposed_collectives=(2 * len(stream.groups_at(0))
                                 + len(stream.groups_at(layer_depths[-1]))),
        extra={"fsdp_working_set": working_set * per})


@target("lm_fsdp_streaming")
def _lm_fsdp_streaming(device) -> Target:
    """Streaming ZeRO-3 step: per-layer AG at point of use, regathered in the
    backward: gathered buffers live at once bounded by fsdp_working_set."""
    t, log, par = _streaming_pieces(True, device)
    return Target("lm_fsdp_streaming", log, streaming_ctx(
        "lm_fsdp_streaming", t._fsdp_layout, log.step.stream,
        par.fsdp_working_set, t.model))


@broken("broken_gather_all_streaming", trips=("AG-ADJACENCY",))
def _broken_gather_all_streaming(device) -> Target:
    """Top-of-step gather-all on the SAME per-layer layout: every buffer is
    gathered at once and read again in the backward (its ctx matches its
    own issue order: one AG per buffer forward, RS reversed)."""
    t, log, par = _streaming_pieces(False, device)
    layout = t._fsdp_layout
    n = layout.n_shards
    per = _per_depth(layout, t.model)
    ctx = LintContext(
        target="broken_gather_all_streaming", expected_permute_total=0,
        expected_rs_elements=[g.padded // n for g in reversed(layout.groups)],
        expected_ag_elements=[g.padded for g in layout.groups],
        wire_dtype_elements=_fsdp_budget(layout), expect_donation=True,
        max_exposed_collectives=2 * len(layout.groups),
        extra={"fsdp_working_set": par.fsdp_working_set * per})
    return Target("broken_gather_all_streaming", log, ctx)


# ------------------------------------------------------------- MoE EP a2a
A2AS_MOE = lambda chunks: 4 * chunks


@target("lm_moe_ep")
def _lm_moe_ep(device) -> Target:
    """MoE EP grads, a2a_scan chunked (Q=2): dispatch k+1 flies behind FFN k."""
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import init_from_specs
    from repro_torch.models.moe import moe_apply, moe_specs

    q = 2
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), device)
    p = init_from_specs(moe_specs(cfg), 0, mesh.device)
    for w in p.values():
        w.requires_grad_(True)
    x = torch.randn(8, 32, cfg.d_model, device=mesh.device,
                    dtype=torch.bfloat16, requires_grad=True)

    def step():
        y, aux = moe_apply(p, x, cfg, mesh, a2a_chunks=q)
        loss = torch.sum(y.float() ** 2) + aux
        return torch.autograd.grad(loss, [*p.values(), x])

    # exposed: slice 0's dispatch (the fill) and the last combine (the
    # drain), the backward's 2Q all-to-alls (issued synchronously where
    # autograd reaches them), and the all-gather of y over the line with
    # its backward all-reduce
    ctx = LintContext(target="lm_moe_ep", expected_permute_total=0,
                      expected_a2a_total=A2AS_MOE(q), scalar_elements=2048,
                      max_exposed_collectives=2 + 2 * q + 2)
    return Target("lm_moe_ep", _run(mesh, step), ctx)


# ------------------------------------------------------------ TP decode
def _decode_tp_target(name: str, mode: str, device) -> Target:
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.decode_tp import build_decode_step
    from repro_torch.models.model import ModelOptions, build_model
    from repro_torch.runtime.server import make_slot_caches

    cfg = get_arch("qwen3-8b").reduced()     # dense GQA + qk-norm
    model = build_model(cfg, ModelOptions(attn_impl="dense"))
    mesh = make_mesh((2, 2), ("data", "model"), device)
    slots, max_len = 8, 16
    step_fn = build_decode_step(model, mesh, mode=mode)
    params = model.init(0, mesh.device)
    caches = make_slot_caches(model, slots, max_len, mesh.device)
    tok = torch.randint(0, cfg.vocab_size, (slots, 1), device=mesh.device)
    pos = torch.arange(slots, device=mesh.device)

    def step():
        logits, new = step_fn(params, tok, caches, pos)
        return new, logits

    return Target(name, _run(mesh, step, caches),
                  decode_ctx(name, cfg, slots, mesh, mode))


def decode_ctx(name: str, cfg, slots: int, mesh, mode: str = "hdot"
               ) -> LintContext:
    """The expectations of one TP decode step (``models.decode_tp``) of
    `slots` slots on a ("data", "model") `mesh`: its ring sends
    (``expected_permute_total``), the caches updated in place, and no
    exposed collective but the logits' all-gather over "data" after the
    last ring. Per-slot bookkeeping (cache positions, masks, rope tables
    of slots x window elements) is below ``scalar_elements``."""
    from repro_torch.models.decode_tp import expected_permute_total

    dp, tp = mesh.shape["data"], mesh.shape["model"]
    expected = (expected_permute_total(cfg, slots, dp, tp)
                if mode == "hdot" else 0)
    return LintContext(target=name, expected_permute_total=expected,
                       max_exposed_collectives=int(dp > 1),
                       expect_donation=True, scalar_elements=128)


@target("lm_decode_tp")
def _lm_decode_tp(device) -> Target:
    """TP continuous-decode step: (4L+1) hdot rings, zero exposed sends."""
    return _decode_tp_target("lm_decode_tp", "hdot", device)


# ------------------------------------------------------------ TP training
def _tp_trainer(device):
    from repro_torch.config.base import ParallelConfig

    # unrolled: a gather-all gathers each layer's leaves apart, so that
    # the working set counts layers (a scanned leaf's gather holds all)
    par = ParallelConfig(scan_layers=False, remat="full")
    return _trainer(par, (2, 2), ("data", "model"), device)


def tp_gathers(plan) -> Tuple[int, int]:
    """(top, layer): the data-axis all-gathers of the TP step's leaves
    outside the layer stack (once a step) and of its largest layer."""
    top, per_layer = 0, {}
    for i, (data, _) in enumerate(plan._data):
        if i not in plan.stack:
            top += len(data)
            continue
        key = 0 if plan.scanned else plan.paths[i][1]
        per_layer[key] = per_layer.get(key, 0) + len(data)
    return top, max(per_layer.values(), default=0)


def tp_train_ctx(name: str, plan, cfg, parallel) -> LintContext:
    """The expectations of one TP train step on `plan` (model config
    `cfg`): no sends, the state updated in place, at most two layers'
    data-axis gathers live at once beside those of the leaves outside the
    stack, and under expert parallelism the all-to-alls of every MoE
    layer (2Q forward, 2Q again in a remat recompute, 2Q backward, each
    microbatch). The step issues its collectives synchronously: it claims
    no overlap window."""
    from repro_torch.models.transformer import block_kinds

    top, layer = tp_gathers(plan)
    ctx = LintContext(
        target=name, expected_permute_total=0, expect_donation=True,
        max_exposed_collectives=None,
        extra={"fsdp_working_set": top + 2 * layer,
               "ag_axes": plan.data_axes})
    if cfg.moe is not None and cfg.moe.num_experts % plan.tp == 0:
        passes = 3 if parallel.remat in ("full", "dots") else 2
        moe_layers = sum(k == "attn_moe" for k in block_kinds(cfg))
        ctx.expected_a2a_total = (2 * parallel.moe_a2a_chunks * passes
                                  * moe_layers * parallel.accum_steps)
    return ctx


@target("lm_tp_train")
def _lm_tp_train(device) -> Target:
    """TP train step on (2, 2): each layer's data blocks gathered in its
    remat region; gathered buffers live at once <= 2 layers' blocks."""
    t, _ = _tp_trainer(device)
    log = _train_log(t)
    return Target("lm_tp_train", log, tp_train_ctx(
        "lm_tp_train", t._tp, t.run.model, t.run.parallel))


def gather_all_tp_step(model, parallel, plan, opt_cfg,
                       warmup_steps: int = 2, total_steps: int = 10
                       ) -> Callable:
    """The TP step with every leaf's data blocks gathered at its top and
    the whole-block gradients taken back through the gathers once (the
    schedule the per-layer gathers replaced), rebuilt from
    ``TPPlan.gather_data``."""
    from repro_torch.core.overlap import accumulate_grads, pmean
    from repro_torch.models.layers import rebuild, tree_leaves
    from repro_torch.optim import adamw_update, warmup_cosine
    from repro_torch.sharding.tp import global_norm_by_class

    inv_tp = 1.0 / plan.tp

    def loss_and_grad(blocks, batch):
        view = {p: plan.model_view(i, b)
                for i, (p, b) in enumerate(zip(plan.paths, blocks))}
        loss = model.train_loss(rebuild(plan.spec_tree, view), batch,
                                tp=plan.cut)
        return loss.detach(), list(torch.autograd.grad(loss * inv_tp, blocks))

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        full = [plan.gather_data(i, w) for i, w in enumerate(leaves)]
        loss, acc = accumulate_grads(
            loss_and_grad, [f.detach().requires_grad_() for f in full],
            batch, parallel.accum_steps)
        grads = []
        for f, w, a in zip(full, leaves, acc):
            if f is not w:
                a = torch.autograd.grad(f, w, a.to(f.dtype))[0]
            grads.append(a.div_(plan.dp) if plan.dp > 1 else a)
        loss = pmean(loss, plan.mesh, plan.mesh.axis_names)
        gnorm = global_norm_by_class(grads, plan.classes, plan.mesh)
        lr = warmup_cosine(opt_state["step"], opt_cfg.lr, warmup_steps,
                           total_steps)
        params, opt_state, gnorm = adamw_update(
            rebuild(plan.spec_tree, dict(zip(plan.paths, grads))), opt_state,
            params, opt_cfg, lr, gnorm=gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


@broken("broken_tp_gather_all", trips=("AG-ADJACENCY",))
def _broken_tp_gather_all(device) -> Target:
    """The TP step gathering every leaf's data blocks at its top: every
    layer's gathered blocks live into the backward at once."""
    t, _ = _tp_trainer(device)
    train = t.run.train
    step = gather_all_tp_step(t.model, t.run.parallel, t._tp, t.opt_cfg,
                              train.warmup_steps, train.total_steps)
    log = _train_log(t, step)
    return Target("broken_tp_gather_all", log, tp_train_ctx(
        "broken_tp_gather_all", t._tp, t.run.model, t.run.parallel))


# ------------------------------------------------- mutation fixtures
@broken("broken_unpeeled_halo1d", trips=("DEAD-DRAIN", "PAIR-COUNT"))
def _broken_unpeeled(device) -> Target:
    """Unpeeled drain: a dead exchange and one pair too many."""
    return _halo_target("broken_unpeeled_halo1d", 1, device, peel=False)


@broken("broken_no_donate_halo1d", trips=("DONATION-LOST",))
def _broken_no_donate(device) -> Target:
    """The halo step handing back a new tensor instead of its state."""
    return _halo_target("broken_no_donate_halo1d", 1, device, donate=False)


@broken("broken_tree_grad_sync", trips=("BUCKET-ORDER",))
def _broken_tree_order(device) -> Target:
    """Buckets issued shallowest-first (order='tree'): wrong issue order."""
    return _grad_sync_target("broken_tree_grad_sync", device, order="tree")


@broken("broken_two_phase_grad_sync", trips=("WIRE-WIDEN",))
def _broken_two_phase_sync(device) -> Target:
    """Monolithic two-phase all-reduce of a mixed-dtype tree: the concat
    promotes bf16 grads to f32, full-width wire traffic."""
    from repro_torch.core.overlap import grad_sync
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), device)
    tree = {"wq": torch.randn(64, 8, device=mesh.device,
                              dtype=torch.bfloat16),
            "norm": torch.randn(64, device=mesh.device)}
    log = _run(mesh, lambda: grad_sync(tree, mesh, ("data",),
                                       mode="two_phase"))
    ctx = LintContext(target="broken_two_phase_grad_sync",
                      wire_dtype_elements={"bf16": 64 * 8, "f32": 64})
    return Target("broken_two_phase_grad_sync", log, ctx)


@broken("broken_two_phase_heat2d", trips=("NO-OVERLAP-WINDOW",))
def _broken_two_phase_heat2d(device) -> Target:
    """two_phase heat2d: exchange -> wait -> compute, nothing overlaps."""
    return _heat2d_target("broken_two_phase_heat2d", device, (32, 32), (4,),
                          mode="two_phase")


@broken("broken_two_phase_decode_tp", trips=("NO-OVERLAP-WINDOW",))
def _broken_two_phase_decode_tp(device) -> Target:
    """Two-phase TP decode: synchronous all-gather / reduce-scatter walls
    around every projection; its send count (0) stays green."""
    return _decode_tp_target("broken_two_phase_decode_tp", "two_phase",
                             device)
