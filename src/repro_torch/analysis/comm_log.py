"""The issue-order log of a step's ``torch.distributed`` calls and the
aten ops between them: the port's counterpart of ``repro/analysis/
hlo_ir.py`` and ``hlo.py``.

The JAX package lints the pre-optimization HLO of a lowered program: its
instructions in trace order, their operands and users. The port makes no
HLO; what it has is the order in which one rank issues its work. While
:func:`record` is entered, a :class:`CommLog` gets, in issue order:

- every collective and point-to-point call (``fake_run.
  recorded_collectives`` is the one patcher): its kind, the dtype and
  elements of its result, the mesh axes of its group, the peer of a send
  or a receive, whether it is asynchronous, and the storages it reads and
  writes;
- the ``wait`` of each asynchronous call's handle;
- between those, every aten op but views (a ``TorchDispatchMode``, as
  ``fake_run``'s tally has), with the storages it reads and writes and
  whether it computes (matmul, elementwise, reduction or index families)
  or only moves data;
- the ``("ag" | "rs" | "free", key)`` events of the ZeRO-3 schedule
  (``core/overlap.py``), through :meth:`CommLog.fsdp_sink`.

Storages are numbered by first sight and keep their number while they
live (a freed storage's id that Python reuses gets a new number), so two
events touch one buffer exactly when they share a number. On real ranks
(gloo, NCCL) the calls are made; on rank 0 of a fake process group
(``launch.dryrun.fake_group``) they are recorded and not made, so the
buffers a call would write keep whatever they held.

``collective_summary``, ``collective_bytes`` and ``count_ops`` answer
what ``hlo.py``'s ``parse_collectives``, ``collective_bytes`` and
``count_ops`` answer of HLO text.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.fake_run import (CollectiveOp, CollectiveSummary,
                                           _family, group_axes,
                                           recorded_collectives)
from repro_torch.analysis.memtraffic import collective_wire_bytes

COLLECTIVES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
               "broadcast", "send", "recv")
COMPUTE_FAMILIES = ("matmul", "elementwise", "reduction", "index")

# torch dtypes by the JAX package's HLO names, so that dtype budgets read
# the same in both packages' lint contexts
HLO_DTYPE = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
             torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
             torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
             torch.bool: "pred"}
DTYPE_BYTES = {"f32": 4, "f64": 8, "f16": 2, "bf16": 2, "s64": 8, "s32": 4,
               "s16": 2, "s8": 1, "u8": 1, "pred": 1}


def hlo_dtype(dtype: torch.dtype) -> str:
    return HLO_DTYPE.get(dtype, str(dtype).replace("torch.", ""))


@dataclass(frozen=True)
class Event:
    """One entry of the log. `kind` is a collective kind
    (:data:`COLLECTIVES`), ``"wait"`` (`handle` names the call it ends),
    ``"op"`` (an aten op, `name` its name) or a ZeRO-3 schedule event
    (``"ag"``, ``"rs"``, ``"free"``; `name` the buffer key)."""

    index: int
    kind: str
    name: str = ""
    dtype: str = ""
    elements: int = 0
    axes: Tuple[str, ...] = ()
    group_size: int = 1
    peer: Optional[int] = None
    async_op: bool = False
    handle: Optional[int] = None
    reads: FrozenSet[int] = frozenset()
    writes: FrozenSet[int] = frozenset()
    compute: bool = False

    @property
    def is_collective(self) -> bool:
        return self.kind in COLLECTIVES

    @property
    def result_bytes(self) -> float:
        return self.elements * DTYPE_BYTES.get(self.dtype, 4)

    @property
    def wire_bytes(self) -> float:
        """Ring-model bytes of a collective (``memtraffic``); a send
        moves its buffer once, a receive nothing of its own."""
        if self.kind == "send":
            return self.result_bytes
        if self.kind in ("recv", "broadcast") or not self.is_collective:
            return 0.0
        return collective_wire_bytes(self.kind, self.result_bytes,
                                     self.group_size)

    def __str__(self) -> str:
        if self.kind == "op":
            return f"#{self.index} op {self.name}"
        if self.kind == "wait":
            return f"#{self.index} wait #{self.handle}"
        if not self.is_collective:
            return f"#{self.index} {self.kind} {self.name}"
        peer = f" peer={self.peer}" if self.peer is not None else ""
        mode = " async" if self.async_op else ""
        return (f"#{self.index} {self.kind} {self.dtype}[{self.elements}] "
                f"axes={','.join(self.axes) or '-'}{peer}{mode}")


class _Sink(list):
    """A list that also logs what is appended to it: the ZeRO-3 schedule's
    ``(kind, key)`` events."""

    def __init__(self, log: "CommLog"):
        super().__init__()
        self._log = log

    def append(self, item) -> None:
        super().append(item)
        kind, key = item
        self._log.add(kind, name=str(key))


@dataclass
class CommLog:
    """One rank's events in issue order (see the module docstring).
    `state_in` / `state_out` are the storages of a step's state before and
    after it (:meth:`mark_state`); `outputs` those the step returned."""

    events: List[Event] = field(default_factory=list)
    mesh: object = None
    state_in: Optional[FrozenSet[int]] = None
    state_out: Optional[FrozenSet[int]] = None
    outputs: FrozenSet[int] = frozenset()

    def __post_init__(self):
        self._lock = threading.Lock()
        self._serial: Dict[int, int] = {}
        self._next = 0
        self._axes = group_axes(self.mesh) if self.mesh is not None else {}

    # ------------------------------------------------------------ storages
    def storage(self, t: torch.Tensor) -> int:
        """The number of `t`'s storage (given at first sight)."""
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            n = self._serial.get(key)
            if n is None:
                n = self._serial[key] = self._next
                self._next += 1
                weakref.finalize(st, self._forget, key, n)
        return n

    def _forget(self, key: int, n: int) -> None:
        with self._lock:
            if self._serial.get(key) == n:
                del self._serial[key]

    def storages(self, tree) -> FrozenSet[int]:
        return frozenset(self.storage(t) for t in tree_flatten(tree)[0]
                         if isinstance(t, torch.Tensor))

    def mark_state(self, tree, after: bool = False) -> None:
        """Record the storages of a step's state, before it or after; a
        0-d leaf (a step counter) is bookkeeping and not recorded."""
        st = frozenset(self.storage(t) for t in tree_flatten(tree)[0]
                       if isinstance(t, torch.Tensor) and t.dim() > 0)
        if after:
            self.state_out = st
        else:
            self.state_in = st

    def mark_outputs(self, tree) -> None:
        self.outputs = self.storages(tree)

    # -------------------------------------------------------------- events
    def add(self, kind: str, **kw) -> int:
        with self._lock:
            i = len(self.events)
            self.events.append(Event(i, kind, **kw))
        return i

    def group_axes(self, group) -> Tuple[str, ...]:
        if group is None:
            return tuple(self.mesh.axis_names) if self.mesh else ()
        return self._axes.get(id(group), ())

    def peer_axes(self, peer: int) -> Tuple[str, ...]:
        """The mesh axes along which `peer` differs from this rank."""
        if self.mesh is None:
            return ()
        from repro_torch.launch.mesh import rank_coords

        mine = rank_coords(self.mesh.rank, self.mesh.sizes)
        theirs = rank_coords(peer, self.mesh.sizes)
        return tuple(a for a, x, y in zip(self.mesh.axis_names, mine, theirs)
                     if x != y)

    def fsdp_sink(self) -> list:
        """A list to pass as the ZeRO-3 step's `log`: its ``("ag" | "rs"
        | "free", key)`` entries land here too, in issue order."""
        return _Sink(self)

    # ------------------------------------------------------------- queries
    def collectives(self, kinds: Optional[Sequence[str]] = None
                    ) -> List[Event]:
        kinds = COLLECTIVES if kinds is None else tuple(kinds)
        return [e for e in self.events if e.kind in kinds]

    def ops(self, compute: Optional[bool] = None) -> List[Event]:
        return [e for e in self.events if e.kind == "op"
                and (compute is None or e.compute == compute)]

    def wait_of(self) -> Dict[int, int]:
        """{collective index: index of the first wait of its handle}."""
        out: Dict[int, int] = {}
        for e in self.events:
            if e.kind == "wait" and e.handle not in out:
                out[e.handle] = e.index
        return out

    def readers(self) -> Dict[int, List[int]]:
        """{storage: indices of the ops that read it, in order}."""
        out: Dict[int, List[int]] = {}
        for e in self.events:
            if e.kind == "op":
                for s in e.reads:
                    out.setdefault(s, []).append(e.index)
        return out

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)


class _OpLog(TorchDispatchMode):
    """Logs every aten op but views and metadata queries, with the
    storages it reads and writes (its outputs, and the arguments its
    schema mutates)."""

    def __init__(self, log: CommLog):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or getattr(func, "is_view", False):
            return out
        log = self.log
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        writes = {log.storage(t) for t in outs}
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                if isinstance(v, torch.Tensor):
                    writes.add(log.storage(v))
        fam = _family(func)
        log.add("op", name=func.overloadpacket.__name__,
                reads=frozenset(log.storage(t) for t in ins),
                writes=frozenset(writes),
                elements=max((t.numel() for t in outs), default=0),
                dtype=hlo_dtype(outs[0].dtype) if outs else "",
                compute=bool(outs) and fam in COMPUTE_FAMILIES)
        return out


@contextlib.contextmanager
def record(mesh=None, make: Optional[bool] = None):
    """Log one rank's work while entered; yields the :class:`CommLog`.
    `mesh` (a ``ProcessMesh``) names the axes of each group. `make`:
    whether the calls are made (default: unless the default process group
    is the fake one)."""
    if make is None:
        make = not (dist.is_initialized() and dist.get_backend() == "fake")
    log = CommLog(mesh=mesh)
    with recorded_collectives(log=log, make=make), _OpLog(log):
        yield log


# ------------------------------------------------------ hlo.py counterparts
def collective_summary(log: CommLog):
    """The log's collectives as ``fake_run.CollectiveSummary`` (kind,
    bytes, ring-model wire bytes, group size): ``hlo.parse_collectives``'
    answer. A send counts as one ``collective-permute``."""
    out = CollectiveSummary()
    for e in log.collectives():
        if e.kind in ("recv", "broadcast"):
            continue
        kind = "collective-permute" if e.kind == "send" else e.kind
        out.ops.append(CollectiveOp(kind, e.result_bytes, e.result_bytes,
                                    e.wire_bytes, e.group_size, e.dtype))
    return out


def collective_bytes(log: CommLog) -> float:
    """Ring-model wire bytes of every collective in the log."""
    return sum(e.wire_bytes for e in log.collectives())


def count_ops(log: CommLog, name: str) -> int:
    """Events named `name`: a collective kind, or an aten op's name."""
    return sum(1 for e in log.events
               if e.kind == name or (e.kind == "op" and e.name == name))
