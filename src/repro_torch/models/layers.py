"""Param specs and common layers (norms, rope, sinusoids, SwiGLU MLP).

The port of ``repro/models/layers.py``. A module publishes a tree of
:class:`ParamSpec` (shape, logical axes, dtype, initializer) in the JAX
package's layout —
``wq`` is (d_model, heads, head_dim), a scanned stack carries a leading
layer dim — so the einsums and the conversion from JAX parameters
(:mod:`repro_torch.models.convert`) stay one-to-one. Materialized
parameters are a :class:`ParamTree`, an ``nn.Module`` that is indexed like
the JAX dict (``p["attn"]["wq"]``). Every spec carries its layer
provenance (``ParamSpec.layer``, the forward depth of the module that owns
it), which the gradient-bucket schedule (``core/overlap.py``) cuts on.

Each leaf's seed comes from a stable hash of its tree path (CRC-32 of its
string), so any subset of leaves inits as in the full tree, and the same
seed gives the same parameters in every process. (The JAX package's
``init_leaf`` folds in Python's ``hash`` of the path, which is salted per
process for strings: port and reference parameters are therefore compared
by converting one tree, never by initializing both.)
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import resolve_device

PyTree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical sharding axes (len == ndim)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # None -> 1/sqrt(fan_in)
    # Layer provenance: forward depth of the (sub)module owning this param.
    # Higher depth = closer to the loss = its gradient is ready EARLIER in
    # the backward pass. A scanned (stacked) layer tree is one depth: its
    # stacked gradient completes at once, when layer 0's backward ends.
    layer: Optional[int] = None

    def __post_init__(self):
        if self.init not in ("normal", "zeros", "ones"):
            raise ValueError(f"unknown init {self.init!r}")
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec shape {tuple(self.shape)} and "
                             f"logical axes {tuple(self.axes)} disagree")


class ParamTree(nn.Module):
    """Nested parameters as an ``nn.Module``: a dict of tensors, dicts and
    lists becomes parameters, child trees and ``nn.ModuleList``s under the
    same keys, read back with ``tree[key]``. Parameters do not require
    grad: serving keeps them so, and the trainer makes them trainable with
    ``requires_grad_()``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def leaf_paths(tree: PyTree, prefix=()) -> Dict[Tuple, Any]:
    """{path: leaf} over nested dicts, lists and :class:`ParamTree`s, in
    the JAX package's tree order (dict keys sorted)."""
    out = {}
    if isinstance(tree, ParamTree):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaf_paths(tree[k], prefix + (k,)))
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        for i, v in enumerate(tree):
            out.update(leaf_paths(v, prefix + (i,)))
    else:
        out[prefix] = tree
    return out


def tree_map(fn, tree: PyTree) -> PyTree:
    """`tree`'s structure as nested dicts and lists (a :class:`ParamTree`
    becomes a dict), with ``fn(leaf)`` at every leaf."""
    if isinstance(tree, ParamTree):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of `tree` in the JAX package's order (``jax.tree.leaves``
    of the same tree)."""
    return list(leaf_paths(tree).values())


def rebuild(tree: PyTree, leaves: Dict[Tuple, Any], prefix=()) -> PyTree:
    """`tree`'s structure (dicts and lists) with `leaves[path]` at each leaf."""
    if isinstance(tree, dict):
        return {k: rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree)]
    return leaves[prefix]


def leaf_seed(seed: int, path: Tuple) -> int:
    """A 32-bit seed for one leaf (the CPU generator keeps 32 bits), stable
    across processes and runs: CRC-32 of the path, started from `seed`."""
    return zlib.crc32(repr(path).encode(), int(seed) % 2**32)


# f32 elements drawn at once by init_leaf (1 GiB): a larger leaf is drawn
# by slabs along dim 0
INIT_SLAB_ELEMS = 2 ** 28


def init_leaf(seed: int, path: Tuple, spec: ParamSpec,
              device="cuda") -> torch.Tensor:
    """Materialize ONE leaf from its path's seed: normal(0, 1) draws in f32
    times `scale` (default 1/sqrt(fan_in)), cast to the spec's dtype.

    The leaf is made in its own dtype and filled by slabs along dim 0 of at
    most ``INIT_SLAB_ELEMS`` elements, each drawn in f32 from the leaf's one
    generator and scaled in place, so the transient is one slab's f32 (a
    stacked expert leaf of Qwen3-30B-A3B is 9.7e9 elements). A leaf that
    fits one slab is one draw, as it always was; a larger one draws other
    values than a single draw of the whole leaf would."""
    device = resolve_device(device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    row = max(1, math.prod(spec.shape[1:]))
    step = max(1, INIT_SLAB_ELEMS // row)
    for i in range(0, spec.shape[0], step):
        slab = out[i:i + step]
        n = torch.randn(slab.shape, generator=gen, dtype=torch.float32,
                        device=device)
        slab.copy_(n.mul_(scale))
    return out


def init_from_specs(specs: PyTree, seed: int = 0, device="cuda") -> PyTree:
    """Materialize every leaf of a spec tree (nested dicts/lists of
    tensors, in the spec tree's structure)."""
    leaves = {p: init_leaf(seed, p, s, device)
              for p, s in leaf_paths(specs).items()}
    return rebuild(specs, leaves)


def map_specs(fn, specs: PyTree) -> PyTree:
    """`specs` with `fn` applied to every :class:`ParamSpec`."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return [map_specs(fn, v) for v in specs]
    return fn(specs)


def abstract_from_specs(specs: PyTree) -> PyTree:
    """Shape-and-dtype stand-ins of every leaf: meta-device tensors (no
    storage), as the JAX package's ``ShapeDtypeStruct``s."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


def axes_from_specs(specs: PyTree) -> PyTree:
    """Logical-axes tree (same structure as the params): each leaf's
    ``ParamSpec.axes``, which ``sharding.rules.resolve_pspec`` places."""
    return map_specs(lambda s: s.axes, specs)


def layers_from_specs(specs: PyTree) -> PyTree:
    """Layer-provenance tree (same structure as the params): each leaf's
    forward depth, untagged specs defaulting to depth 0 (the input end,
    whose gradients complete last)."""
    return map_specs(lambda s: 0 if s.layer is None else s.layer, specs)


def tag_layer(specs: PyTree, depth: int) -> PyTree:
    """Stamp `depth` as the layer provenance of every spec in the subtree."""
    return map_specs(lambda s: dataclasses.replace(s, layer=depth), specs)


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, rounded once to x's dtype. ``F.rms_norm`` reduces
    each row in an order set by the row's width alone (on CUDA one fused
    kernel, a row a block), where ``torch.mean`` over the last dim splits a
    lone row over other threads than a row among 8: a request's decode
    must not depend on how many slots run beside it."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight.float(),
                      eps).to(x.dtype)


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   width: int, reduce) -> torch.Tensor:
    """:func:`rms_norm` over a last dim split across ranks: `x` and
    `weight` hold this rank's columns, `width` is the whole dim, and
    `reduce` sums a tensor over the ranks (``TPCut.all_reduce``). The
    float32 sum of squares of the rank's columns is summed over the
    ranks and divided by the whole width, as GSPMD computes the mean
    of a split dim with a partial sum."""
    xf = x.float()
    ss = reduce(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf * torch.rsqrt(ss / width + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (Whisper's, with bias) in f32, rounded once to x's dtype:
    the mean, then the mean of the squared deviations, as the reference
    computes them."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def sinusoidal_embedding(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) f32 sinusoids: sin on the even columns, cos on the odd,
    frequencies exp(-ln(10000) j / dim) for j = 0, 2, ... Built on
    `device` (no host-to-device copy). The exponential is taken in f64
    and rounded once: the correctly rounded frequencies, which the
    reference's compiled exp gives (a 1-ulp error in one would move the
    angle at position 1500 by ~1e-4)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=device) * (-math.log(10000.0) / dim)
    div = torch.exp(exps.double()).float()
    emb = torch.empty((seq, dim), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(pos * div)
    emb[:, 1::2] = torch.cos(pos * div)
    return emb


_PROJECTING = [0]


def project(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` for a weight projection, a product with
    no batch dims. einsum lowers it to a ``bmm`` of batch 1, which
    :func:`projecting` marks while it runs, so that remat "dots" can tell
    it from a batched product (``models/transformer.py``)."""
    _PROJECTING[0] += 1
    try:
        return torch.einsum(eq, x, w)
    finally:
        _PROJECTING[0] -= 1


def projecting() -> bool:
    """Whether a :func:`project` product is running."""
    return _PROJECTING[0] > 0


def promoted_einsum(eq: str, x: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """:func:`project` over operands of two dtypes, computed in the wider
    one, as ``jnp.einsum`` and ``@`` promote them (torch refuses the
    mix)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return project(eq, x.to(dt), w.to(dt))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Half-split
    rotation in f32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 inputs of x (b, l, c) as the decode conv state,
    left-padded with zeros when l < k-1: the full-sequence conv zero-pads
    the same rows, so decode continues exactly. (The JAX package keeps
    ``x[:, -(k-1):]``, fewer rows than its cache holds for such prompts;
    ``ROADMAP.md`` Queue 3.)"""
    tail = x[:, -(k - 1):]
    short = (k - 1) - tail.shape[1]
    if short > 0:
        tail = F.pad(tail, (0, 0, short, 0))
    return tail


# ---------------------------------------------------------------- dense MLP
def mlp_specs(d_model: int, d_ff: int,
              dtype=torch.bfloat16) -> Dict[str, ParamSpec]:
    return {
        "gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
        "up": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
        "down": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    h = torch.nn.functional.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]
