"""One pass of a step under fake tensors: the port's counterpart of the
compiled artifact that the JAX package's dry run reads.

XLA lowers a cell once and answers ``cost_analysis()`` (FLOPs, bytes
accessed), ``memory_analysis()`` (argument, output, alias and temp bytes)
and its HLO text (the collectives). A torch step has no such artifact, so
:func:`fake_pass` runs it once for one rank on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes and
storages, no data, no device) and counts as it goes:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, forward and
  backward;
- bytes accessed: the bytes of the inputs and outputs of every aten op
  that is not a view. No kernel fusion is assumed, so like XLA-CPU's
  figure this is an unfused upper bound, not what a card moves;
- collectives: every ``torch.distributed`` call the step makes, those of
  the autograd Functions' backwards included, by kind, result bytes and
  group size (:class:`CollectiveSummary`, wire bytes by the ring model of
  ``memtraffic.collective_wire_bytes``); a ``batch_isend_irecv`` counts
  each of its sends as one ``collective-permute``. The calls are
  recorded, not made (the fake process group moves nothing);
- memory (:class:`MemoryStats`): XLA's ``memory_analysis()`` has no torch
  equivalent. Instead the bytes of live storages are tracked: an untyped
  storage is counted once (views share it) when an op first returns it,
  and dropped when it is freed (``weakref.finalize``); the arguments'
  storages are counted apart, and the temp figure is the peak of the
  others, outputs included. A kernel's own scratch is not seen, except
  where :data:`_HIDDEN_TEMPS` names it as the card's kernels hold it
  (logsumexp's copy of its input, the softmax backward's contiguous
  copies), so the figure estimates the card's peak;
- aten ops by family (:data:`FAMILIES`), in place of the HLO op counts.

A step whose data decides a shape or a branch (``.item()``, ``bool`` of
a tensor) cannot run here: the port keeps such values as tensors.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.memtraffic import collective_wire_bytes


# ------------------------------------------------------------ collectives
@dataclass
class CollectiveOp:
    kind: str                  # all-gather | reduce-scatter | all-reduce | ...
    result_bytes: float        # per-rank result buffer size
    operand_bytes: float       # per-rank operand size
    wire_bytes: float          # ring-model per-rank wire traffic
    group_size: int
    dtype: str = ""
    axes: Tuple[str, ...] = ()  # the mesh axes of its group, where known

    @property
    def wire_bytes_bf16eq(self) -> float:
        """The JAX package halves XLA-CPU's large f32 collectives here,
        because XLA-CPU upcasts bf16 dots before partitioning and a TPU
        would move bf16. The port's collectives run in the dtypes the card
        moves (an f32 one is f32 on the card too), so no correction
        applies: the wire bytes themselves."""
        return self.wire_bytes


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    @property
    def total_wire_bytes_bf16eq(self) -> float:
        return sum(o.wire_bytes_bf16eq for o in self.ops)

    @property
    def total_operand_bytes(self) -> float:
        return sum(o.operand_bytes for o in self.ops)

    def by_kind(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            n, b = out.get(o.kind, (0, 0.0))
            out[o.kind] = (n + 1, b + o.wire_bytes)
        return out

    def by_axes(self) -> Dict[str, Tuple[int, float]]:
        """{mesh axes of the group ("-" unknown): (calls, wire bytes)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            k = ",".join(o.axes) or "-"
            n, b = out.get(k, (0, 0.0))
            out[k] = (n + 1, b + o.wire_bytes)
        return out

    def __str__(self) -> str:
        rows = [f"  {k:20s} n={n:4d}  wire={b/1e9:10.3f} GB"
                for k, (n, b) in sorted(self.by_kind().items())]
        rows.append(f"  {'TOTAL':20s} n={len(self.ops):4d}  "
                    f"wire={self.total_wire_bytes/1e9:10.3f} GB")
        return "\n".join(rows)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Done:
    """The handle of a recorded collective (nothing is in flight)."""

    def wait(self, *a, **k):
        return True


class _Logged:
    """A call's handle whose first ``wait`` is logged (``comm_log``)
    before the call's own handle, if it was made, is waited on."""

    def __init__(self, work, log, index: int):
        self._work, self._log, self._index = work, log, index
        self._waited = False

    def wait(self, *a, **k):
        if not self._waited:
            self._waited = True
            self._log.add("wait", handle=self._index)
        return True if self._work is None else self._work.wait(*a, **k)

    def __getattr__(self, name):
        return getattr(self._work, name)


def group_axes(mesh) -> Dict[int, Tuple[str, ...]]:
    """{id(process group): the mesh axes it spans} of `mesh`'s groups."""
    out = {}
    for key, g in mesh.groups.items():
        if g is not None:
            out[id(g)] = (key,) if isinstance(key, str) else tuple(key)
    return out


@contextlib.contextmanager
def recorded_collectives(log=None, make: bool = False, mesh=None):
    """While entered, the ``torch.distributed`` collectives the port calls
    are recorded into the yielded :class:`CollectiveSummary` instead of
    being made (their output buffers are left as they are). With `log`
    (a ``comm_log.CommLog``) each call is also logged, with its group's
    mesh axes, a send's or receive's peer and the storages it reads and
    writes, and so is the first ``wait`` of each asynchronous handle; with
    `make` the calls are made as well (real ranks). With `mesh` (or a
    `log` that has one) each summary entry names its group's mesh axes."""
    summary = CollectiveSummary()
    saved: Dict[str, Callable] = {}
    mesh = mesh if mesh is not None else getattr(log, "mesh", None)
    axes_of = group_axes(mesh) if mesh is not None else {}
    world = tuple(mesh.axis_names) if mesh is not None else ()

    def log_call(kind, group, dtype, async_op, ins, outs, peer=None):
        from repro_torch.analysis.comm_log import hlo_dtype

        axes = (log.peer_axes(peer) if peer is not None
                else log.group_axes(group))
        return log.add(kind, dtype=hlo_dtype(dtype),
                       elements=sum(t.numel() for t in outs or ins),
                       axes=axes,
                       group_size=dist.get_world_size(group), peer=peer,
                       async_op=bool(async_op),
                       reads=frozenset(log.storage(t) for t in ins),
                       writes=frozenset(log.storage(t) for t in outs))

    def add(kind, result, operand, group, dtype, async_op=False, ins=(),
            outs=()):
        g = dist.get_world_size(group)
        summary.ops.append(CollectiveOp(
            kind, float(result), float(operand),
            collective_wire_bytes(kind, result, g), g,
            str(dtype).replace("torch.", ""),
            world if group is None else axes_of.get(id(group), ())))
        if log is None:
            return None
        return log_call(kind, group, dtype, async_op, ins, outs)

    def done(name, index, is_async, *args, **kwargs):
        work = saved[name](*args, **kwargs) if make else None
        if not is_async:
            return work if make else None
        if index is None:
            return work if make else _Done()
        return _Logged(work, log, index)

    def all_gather_into_tensor(out, inp, group=None, async_op=False):
        i = add("all-gather", _nbytes(out), _nbytes(inp), group, out.dtype,
                async_op, (inp,), (out,))
        return done("all_gather_into_tensor", i, async_op, out, inp,
                    group=group, async_op=async_op)

    def all_gather(outs, inp, group=None, async_op=False):
        i = add("all-gather", sum(_nbytes(o) for o in outs), _nbytes(inp),
                group, inp.dtype, async_op, (inp,), tuple(outs))
        return done("all_gather", i, async_op, outs, inp, group=group,
                    async_op=async_op)

    def reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=None,
                              async_op=False):
        i = add("reduce-scatter", _nbytes(out), _nbytes(inp), group,
                out.dtype, async_op, (inp,), (out,))
        return done("reduce_scatter_tensor", i, async_op, out, inp, op=op,
                    group=group, async_op=async_op)

    def reduce_scatter(out, inputs, op=dist.ReduceOp.SUM, group=None,
                       async_op=False):
        i = add("reduce-scatter", _nbytes(out),
                sum(_nbytes(t) for t in inputs), group, out.dtype, async_op,
                tuple(inputs), (out,))
        return done("reduce_scatter", i, async_op, out, inputs, op=op,
                    group=group, async_op=async_op)

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        i = add("all-reduce", _nbytes(t), _nbytes(t), group, t.dtype,
                async_op, (t,), (t,))
        return done("all_reduce", i, async_op, t, op=op, group=group,
                    async_op=async_op)

    def all_to_all_single(out, inp, *a, group=None, async_op=False, **k):
        i = add("all-to-all", _nbytes(out), _nbytes(inp), group, out.dtype,
                async_op, (inp,), (out,))
        return done("all_to_all_single", i, async_op, out, inp, *a,
                    group=group, async_op=async_op, **k)

    def broadcast(t, src, group=None, async_op=False):
        i = add("broadcast", _nbytes(t), _nbytes(t), group, t.dtype,
                async_op, (t,), (t,))
        return done("broadcast", i, async_op, t, src, group=group,
                    async_op=async_op)

    def batch_isend_irecv(ops):
        idx = []
        for o in ops:
            send = o.op is dist.isend
            if send:
                summary.ops.append(CollectiveOp(
                    "collective-permute", float(_nbytes(o.tensor)),
                    float(_nbytes(o.tensor)), float(_nbytes(o.tensor)),
                    dist.get_world_size(o.group),
                    str(o.tensor.dtype).replace("torch.", "")))
            idx.append(None if log is None else log_call(
                "send" if send else "recv", o.group, o.tensor.dtype, True,
                (o.tensor,) if send else (), () if send else (o.tensor,),
                peer=o.peer))
        works = saved["batch_isend_irecv"](ops) if make else [None] * len(ops)
        return [(w if make else _Done()) if i is None else _Logged(w, log, i)
                for w, i in zip(works, idx)]

    patched = dict(all_gather_into_tensor=all_gather_into_tensor,
                   all_gather=all_gather,
                   reduce_scatter_tensor=reduce_scatter_tensor,
                   reduce_scatter=reduce_scatter,
                   all_reduce=all_reduce, all_to_all_single=all_to_all_single,
                   broadcast=broadcast, batch_isend_irecv=batch_isend_irecv)
    saved.update({k: getattr(dist, k) for k in patched})
    for k, fn in patched.items():
        setattr(dist, k, fn)
    try:
        yield summary
    finally:
        for k, fn in saved.items():
            setattr(dist, k, fn)


# ------------------------------------------------------------- the ops
FAMILIES = ("matmul", "elementwise", "reduction", "index", "copy", "view",
            "factory")
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear",
           "dot", "mv", "addmv", "convolution", "_scaled_mm"}
_REDUCTION = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
              "_softmax", "_log_softmax", "_softmax_backward_data",
              "_log_softmax_backward_data", "cumsum", "sort", "topk",
              "argmax", "argmin", "var", "var_mean", "norm",
              "linalg_vector_norm", "prod", "any", "all",
              "_fused_rms_norm", "_fused_rms_norm_backward",
              "native_layer_norm", "native_layer_norm_backward"}
_INDEX = {"gather", "scatter", "scatter_add", "scatter_reduce", "index",
          "index_put", "index_put_", "_index_put_impl_", "index_select",
          "index_add", "embedding", "embedding_dense_backward",
          "masked_fill", "masked_scatter", "take", "scatter_",
          "scatter_add_", "index_add_", "masked_fill_", "one_hot"}
_COPY = {"copy_", "clone", "_to_copy", "cat", "stack", "contiguous",
         "_unsafe_view", "copy", "repeat", "repeat_interleave", "flip",
         "roll", "constant_pad_nd", "where"}
_FACTORY = {"empty", "empty_like", "zeros", "zeros_like", "ones",
            "ones_like", "full", "full_like", "arange", "new_empty",
            "new_zeros", "new_ones", "new_full", "empty_strided",
            "new_empty_strided", "scalar_tensor", "lift_fresh", "fill_",
            "zero_", "detach"}


def _strided_bytes(args) -> int:
    return sum(_nbytes(a) for a in args
               if isinstance(a, torch.Tensor) and not a.is_contiguous())


# Kernels whose own buffers the dispatcher never sees, with the bytes they
# hold beside their inputs and output, as the card's kernels hold them
# (``tools/hidden_temps.py`` measures them on a training step): logsumexp
# subtracts the max from a copy of its input (the fused loss's f32
# logits); the softmax backward makes a contiguous copy of a strided
# gradient and a contiguous result it then copies out (attention's scores'
# gradient arrives permuted).
_HIDDEN_TEMPS = {
    "logsumexp": lambda args: _nbytes(args[0]),
    "_softmax_backward_data": lambda args: 2 * _strided_bytes(args[:1]),
    "_log_softmax_backward_data": lambda args: 2 * _strided_bytes(args[:1]),
}


def _family(func) -> str:
    name = func.overloadpacket.__name__
    if name in _MATMUL:
        return "matmul"
    if getattr(func, "is_view", False):
        return "view"
    if name in _FACTORY:
        return "factory"
    if name in _REDUCTION:
        return "reduction"
    if name in _INDEX:
        return "index"
    if name in _COPY:
        return "copy"
    return "elementwise"


class _Tally(TorchDispatchMode):
    """Counts aten ops by family and their bytes accessed, and tracks the
    bytes of live storages the step creates (each untyped storage once,
    dropped when freed); `known` are the argument storages' ids, counted
    apart."""

    def __init__(self, known: set):
        super().__init__()
        self.known = known
        self.seen: set = set()
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.ops: Dict[str, int] = {f: 0 for f in FAMILIES}

    def _drop(self, key, n):
        self.live -= n
        self.seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":    # metadata queries (x.device, ...)
            return out
        fam = _family(func)
        self.ops[fam] += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if fam != "view":
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.known or key in self.seen:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._drop, key, n)
        hidden = _HIDDEN_TEMPS.get(func.overloadpacket.__name__)
        if hidden is not None:
            self.peak = max(self.peak, self.live + hidden(args))
        return out


@dataclass
class MemoryStats:
    """Per-rank bytes of one step: its arguments, the new storages among
    its outputs, the outputs that are arguments updated in place (XLA's
    donated aliases), and the peak of the storages it created, live at
    once (outputs included). ``argument + temp`` is the step's peak."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int

    @property
    def peak_bytes(self) -> int:
        return self.argument_size_in_bytes + self.temp_size_in_bytes


@dataclass
class FakePass:
    """What :func:`fake_pass` counted."""

    flops: float
    bytes_accessed: float
    collectives: CollectiveSummary
    memory: MemoryStats
    op_counts: Dict[str, int]


def _storages(tree) -> Dict[int, int]:
    """{id(untyped storage): bytes} of the tensors of `tree` (dicts,
    lists, tuples and ParamTrees)."""
    from repro_torch.models.layers import tree_leaves

    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def fake_pass(step: Callable, args: tuple, fake_mode,
              mesh=None) -> FakePass:
    """Run ``step(*args)`` once under `fake_mode` (the
    ``FakeTensorMode`` the fake `args` were made in), counting FLOPs,
    bytes accessed, aten ops, the collectives (recorded, not made; by the
    axes of `mesh` where given) and the live storages (see the module
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_st = _storages(args)
    tally = _Tally(set(arg_st))
    with fake_mode, recorded_collectives(mesh=mesh) as coll, \
            FlopCounterMode(display=False) as flops, tally:
        out = step(*args)
    out_st = _storages(out)
    mem = MemoryStats(
        argument_size_in_bytes=sum(arg_st.values()),
        output_size_in_bytes=sum(n for k, n in out_st.items()
                                 if k not in arg_st),
        alias_size_in_bytes=sum(n for k, n in out_st.items() if k in arg_st),
        temp_size_in_bytes=tally.peak)
    return FakePass(float(flops.get_total_flops()),
                    float(tally.bytes_accessed), coll, mem, dict(tally.ops))
