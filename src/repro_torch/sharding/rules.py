"""Logical-axis sharding rules with divisibility fixups: the port of
``repro/sharding/rules.py``, pure Python over axis names and sizes.

Model code names each parameter's dims by LOGICAL axes ("embed", "heads",
"vocab", ...; ``ParamSpec.axes``). A :class:`ShardingContext` maps logical
names to mesh axes. Resolution is *ordered and greedy with fixups*:

- each logical name carries a candidate list (first match wins);
- a candidate is accepted only if (a) none of its mesh axes were already used
  by an earlier dim of the same tensor and (b) the dim size is divisible by
  the product of the candidate's mesh axis sizes;
- otherwise the next candidate (ultimately `None` = replicate) is used.

One rule set thus drives every architecture: "heads->model" shards llama3's
128 heads over 16 but replicates llava's 56, "vocab->model" replicates
Granite's odd 49155. The tables are the JAX package's, copied.

The JAX package's ``with_logical`` and ``named_sharding`` hand a resolved
spec to GSPMD, which places the arrays and inserts the collectives. The
port has no partitioner, so they have no counterpart here: the placements
are made by explicit steps instead. :mod:`repro_torch.checkpoint.elastic`
cuts a tree to the blocks a rank holds (and gathers them back), and the
tensor-parallel train step (``launch/steps.py``, with the collectives of
:mod:`repro_torch.sharding.tp`) computes on those blocks.

A context is built over a :class:`~repro_torch.launch.mesh.ProcessMesh` or
over any object with ``axis_names`` and sizes (``sizes``, a ``shape``
dict, or ``devices.shape`` as the JAX package's fake test meshes have), so
the rules resolve for meshes of any size without ranks.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Optional[Tuple[str, ...]]          # one candidate: mesh axes for a dim
Candidates = Sequence[MeshAxes]               # ordered candidates per logical axis
Entry = Union[None, str, Tuple[str, ...]]     # one dim of a PartitionSpec

# --------------------------------------------------------------- default rules
# weight + activation logical axes. ("pod","data") collapses to the axes that
# exist in the mesh (single-pod meshes have no "pod").
DEFAULT_RULES: Dict[Optional[str], Candidates] = {
    # activations
    "batch": [("pod", "data"), ("data",), None],
    "seq": [("model",), None],          # sequence parallelism between blocks
    "kv_seq": [("model",), None],       # decode KV cache length (flash-decode split)
    "act_embed": [None],
    "act_heads": [("model",), None],
    "act_kv_heads": [("model",), None],
    # weights
    "embed": [("pod", "data"), ("data",), None],   # FSDP dim
    "mlp": [("model",), None],
    "heads": [("model",), None],
    "kv_heads": [("model",), None],
    "head_dim": [None],
    "vocab": [("model",), None],
    "experts": [("model",), None],
    "expert_mlp": [("model",), None],
    "lru": [("model",), None],
    "state": [None],
    "conv": [None],
    "layers": [None],                   # scanned-layer leading dim
    None: [None],
}

# Serving (decode): weights fully TP over (model x data), batch over the pod
# axis only, the KV cache's length over (model, data).
SERVE_RULES: Dict[Optional[str], Candidates] = dict(DEFAULT_RULES)
SERVE_RULES.update({
    "batch": [("pod",), None],
    "seq": [None],
    "kv_seq": [("model", "data"), ("model",), None],
    "act_heads": [("model",), None],
    "act_kv_heads": [None],
    "embed": [("data",), None],
    "mlp": [("model", "data"), ("model",), None],
    "heads": [("model", "data"), ("model",), None],
    "kv_heads": [("model",), None],
    "head_dim": [("data",), None],
    "vocab": [("model", "data"), ("model",), None],
    "experts": [("model", "data"), ("model",), None],
    "expert_mlp": [("model", "data"), ("model",), None],
    "lru": [("model", "data"), ("model",), None],
})

# DP x SP recipe: activations shard (batch x seq), heads replicate. Kept for
# the record, as in the JAX package (measured worse there than head TP).
TRAIN_DP_RULES: Dict[Optional[str], Candidates] = dict(DEFAULT_RULES)
TRAIN_DP_RULES.update({
    "act_heads": [None],
    "act_kv_heads": [None],
})


def rules_for(kind: str, d_model: int = 0,
              family: str = "") -> Dict[Optional[str], Candidates]:
    """The recipe of a cell kind: ``SERVE_RULES`` for "decode" (decode
    cannot amortize weight gathers over many tokens, so full TP), else
    ``DEFAULT_RULES`` (train and prefill: FSDP dims plus TP). `d_model`
    and `family` are read nowhere, as in the JAX package."""
    if kind == "decode":
        return dict(SERVE_RULES)
    return dict(DEFAULT_RULES)


class PartitionSpec(tuple):
    """A resolved spec: one entry per dim (None, a mesh axis, or a tuple of
    mesh axes), trailing Nones trimmed. A tuple, so it compares entry by
    entry with ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


P = PartitionSpec


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ProcessMesh (``sizes``), of an object with a
    ``shape`` dict, or of a JAX-style mesh (``devices.shape``)."""
    names = tuple(mesh.axis_names)
    if hasattr(mesh, "sizes"):
        sizes = tuple(mesh.sizes)
    elif isinstance(getattr(mesh, "shape", None), dict):
        sizes = tuple(mesh.shape[a] for a in names)
    else:
        sizes = tuple(mesh.devices.shape)
    return dict(zip(names, (int(s) for s in sizes)))


@dataclass
class ShardingContext:
    mesh: Any
    rules: Dict[Optional[str], Candidates] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def axis_size(self, name: str) -> int:
        return mesh_sizes(self.mesh).get(name, 1)


_LOCAL = threading.local()


def current_context() -> Optional[ShardingContext]:
    return getattr(_LOCAL, "ctx", None)


class use_sharding:
    """Context manager installing mesh+rules for logical resolution."""

    def __init__(self, mesh: Any,
                 rules: Optional[Dict[Optional[str], Candidates]] = None):
        merged = dict(DEFAULT_RULES)
        if rules:
            merged.update(rules)
        self.ctx = ShardingContext(mesh, merged)

    def __enter__(self) -> ShardingContext:
        self._prev = current_context()
        _LOCAL.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _LOCAL.ctx = self._prev
        return False


class no_sharding:
    """Temporarily clear the installed context (resolution outside a
    context places nothing)."""

    def __enter__(self) -> None:
        self._prev = current_context()
        _LOCAL.ctx = None

    def __exit__(self, *exc):
        _LOCAL.ctx = self._prev
        return False


def _mesh_axes_present(ctx: ShardingContext, cand: MeshAxes) -> MeshAxes:
    if cand is None:
        return None
    present = tuple(a for a in cand if a in ctx.mesh.axis_names)
    return present or None


def resolve_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  ctx: Optional[ShardingContext] = None) -> PartitionSpec:
    """Resolve logical axes -> PartitionSpec for a concrete shape (see module
    docstring for the fixup policy)."""
    ctx = ctx or current_context()
    if ctx is None:
        return P()
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(axes)} disagree")
    used: set = set()
    out: List[Entry] = []
    for dim, name in zip(shape, axes):
        placed: MeshAxes = None
        for cand in ctx.rules.get(name, [None]):
            cand = _mesh_axes_present(ctx, cand)
            if cand is None:
                placed = None
                break
            if any(a in used for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= ctx.axis_size(a)
            if prod <= 1 or dim % prod != 0:
                continue
            placed = cand
            break
        if placed is None:
            out.append(None)
        else:
            used.update(placed)
            out.append(placed if len(placed) > 1 else placed[0])
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def explain_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  ctx: Optional[ShardingContext] = None) -> str:
    spec = resolve_pspec(shape, axes, ctx)
    return f"{tuple(shape)} {tuple(axes)} -> {spec}"


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)
