"""Hierarchical domain over-decomposition (paper §3.1-3.2).

The paper's central idea: *reuse the process-level partitioning scheme at task
level*. ``decompose_grid`` is that single scheme; ``Domain`` applies it at
process level (mesh shards) and ``Domain.over_decompose`` applies the SAME
function again at task level, producing :class:`SubDomain` lists with
``is_boundary`` checks (paper Code 4) and halo accounting (paper Table 1).

Pure python — the port's own copy of ``repro.core.domain`` (the PyTorch
package imports nothing of the JAX one), kept line for line so both packages
cut every grid identically; ``tests/test_torch_domain.py`` holds them equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Box:
    """Half-open index box: per-dim [start, stop)."""

    start: Tuple[int, ...]
    stop: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.start) == len(self.stop)
        assert all(a <= b for a, b in zip(self.start, self.stop)), (self.start, self.stop)

    @property
    def ndim(self) -> int:
        return len(self.start)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.start, self.stop))

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(a, b) for a, b in zip(self.start, self.stop))

    def contains(self, other: "Box") -> bool:
        return all(
            sa <= oa and ob <= sb
            for sa, oa, ob, sb in zip(self.start, other.start, other.stop, self.stop)
        )

    def shifted(self, offset: Sequence[int]) -> "Box":
        return Box(
            tuple(a + o for a, o in zip(self.start, offset)),
            tuple(b + o for b, o in zip(self.stop, offset)),
        )


def _split_extent(extent: int, parts: int) -> List[Tuple[int, int]]:
    """Split [0, extent) into `parts` contiguous ranges, remainder spread over
    the leading parts (the classic MPI block distribution)."""
    if parts < 1:
        raise ValueError(f"cannot split extent {extent} into {parts} parts")
    base, rem = divmod(extent, parts)
    out = []
    cur = 0
    for p in range(parts):
        n = base + (1 if p < rem else 0)
        out.append((cur, cur + n))
        cur += n
    assert cur == extent
    return out


def _split_extent_weighted(extent: int, parts: int,
                           weights: Sequence[float]) -> List[Tuple[int, int]]:
    """Split [0, extent) into `parts` contiguous ranges so each part's summed
    per-cell cost approaches total/parts. Cut p is placed at the first cell
    where the cost prefix crosses p/parts of the total, then clamped so every
    part keeps >= 1 cell (when extent >= parts). Guarantees: contiguous
    disjoint cover, monotone cut positions, and
    max part cost <= total/parts + max(weights)."""
    if parts < 1:
        raise ValueError(f"cannot split extent {extent} into {parts} parts")
    w = [float(x) for x in weights]
    if len(w) != extent:
        raise ValueError(
            f"weighted split needs one cost per cell: got {len(w)} weights "
            f"for extent {extent}")
    neg = [x for x in w if x < 0]
    if neg:
        raise ValueError(f"cell weights must be non-negative, got {neg[:3]}")
    total = sum(w)
    if total <= 0.0 or all(x == w[0] for x in w):
        # no signal, or a flat profile: equal-cost cells carry no preference
        # between balanced cuts, so collapse onto the uniform distribution
        # (keeps flat re-measurements from flipping the cut and recompiling)
        return _split_extent(extent, parts)
    prefix = [0.0] * (extent + 1)
    for i, x in enumerate(w):
        prefix[i + 1] = prefix[i] + x
    reserve = 1 if extent >= parts else 0
    cuts = [0]
    for p in range(1, parts):
        target = total * p / parts
        c = cuts[-1]
        while c < extent and prefix[c] < target:
            c += 1
        c = max(c, cuts[-1] + reserve)
        c = min(c, extent - reserve * (parts - p))
        cuts.append(c)
    cuts.append(extent)
    return [(cuts[p], cuts[p + 1]) for p in range(parts)]


def _is_extents(entry, parts: int, extent: int) -> bool:
    """True when `entry` spells explicit per-part extents (len == parts ints
    summing to extent) rather than per-cell costs."""
    try:
        vals = list(entry)
    except TypeError:
        return False
    return (len(vals) == parts
            and all(isinstance(v, int) or (hasattr(v, "is_integer")
                                           and float(v).is_integer())
                    for v in vals)
            and sum(int(v) for v in vals) == extent)


def split_ranges(extent: int, parts: int,
                 weights=None) -> List[Tuple[int, int]]:
    """One dimension of THE partition scheme, with an optional measured-cost
    path. `weights` is one of:

    - ``None`` — the classic uniform block distribution (bit-identical to the
      historical `_split_extent`),
    - explicit per-part extents (`parts` ints summing to `extent`) — a
      canonical cut, used as jit-cache keys by the solvers,
    - per-cell costs (`extent` non-negative floats) — cut so each part's
      summed cost is within max(weights) of the total/parts ideal.
    """
    if weights is None:
        return _split_extent(extent, parts)
    if _is_extents(weights, parts, extent):
        out = []
        cur = 0
        for v in weights:
            n = int(v)
            if n < 0:
                raise ValueError(f"part extents must be >= 0, got {tuple(weights)}")
            out.append((cur, cur + n))
            cur += n
        return out
    return _split_extent_weighted(extent, parts, weights)


def part_extents(extent: int, parts: int, weights=None) -> Tuple[int, ...]:
    """The canonical (hashable) form of one dimension's cut: per-part extents.
    `part_extents(e, p, w)` is idempotent — feeding the result back in as
    `weights` reproduces the same cut — which is what lets the solvers
    compare a re-measured cut with the one they run."""
    return tuple(b - a for a, b in split_ranges(extent, parts, weights))


def _norm_weights(weights, ndim: int):
    """Normalize a per-dim weights spec to a list of ndim entries (None or a
    per-dim sequence)."""
    if weights is None:
        return [None] * ndim
    weights = list(weights)
    if len(weights) != ndim:
        raise ValueError(
            f"weights names {len(weights)} dims but the space is {ndim}-d — "
            f"one entry (or None) per dim required")
    return weights


def decompose_grid(shape: Sequence[int], parts: Sequence[int],
                   weights=None) -> List[Box]:
    """THE partition scheme (used identically at process- and task-level).

    Splits an N-d index space of `shape` into a grid of `parts[i]` blocks per
    dimension, row-major order. Every cell belongs to exactly one box.
    `weights` (optional, one entry per dim) routes a dim through the
    measured-cost cut of :func:`split_ranges`; ``None`` entries stay uniform.
    """
    if len(shape) != len(parts):
        raise ValueError(
            f"shape {tuple(shape)} is {len(shape)}-d but parts "
            f"{tuple(parts)} names {len(parts)} dims — one block count per "
            f"dim required")
    wts = _norm_weights(weights, len(shape))
    per_dim = [split_ranges(e, p, wd)
               for e, p, wd in zip(shape, parts, wts)]

    boxes: List[Box] = []

    def rec(d: int, start: List[int], stop: List[int]):
        if d == len(shape):
            boxes.append(Box(tuple(start), tuple(stop)))
            return
        for a, b in per_dim[d]:
            rec(d + 1, start + [a], stop + [b])

    rec(0, [], [])
    return boxes


def halo_cells(box: Box, global_shape: Sequence[int], width: int,
               dims: Optional[Sequence[int]] = None, periodic: bool = False) -> int:
    """Number of halo cells this box must allocate (paper Table 1 accounting):
    one `width`-deep slab per face that has a neighbor."""
    dims = range(box.ndim) if dims is None else dims
    total = 0
    for d in dims:
        face = box.size // max(box.shape[d], 1)
        lo_neighbor = periodic or box.start[d] > 0
        hi_neighbor = periodic or box.stop[d] < global_shape[d]
        total += width * face * (int(lo_neighbor) + int(hi_neighbor))
    return total


@dataclass(frozen=True)
class SubDomain:
    """A task-level data partition (paper §3.2). Carries its geometric position
    so `is_boundary` can gate communication tasks (paper Code 4's isBoundary)."""

    box: Box                      # in GLOBAL coordinates
    local_box: Box                # in the owning domain's LOCAL coordinates
    domain_box: Box               # the owning process-level domain
    global_shape: Tuple[int, ...]
    index: Tuple[int, ...]        # position in the subdomain grid
    grid: Tuple[int, ...]         # subdomain grid shape

    def is_boundary(self, dim: Optional[int] = None, side: Optional[str] = None) -> bool:
        """True if this subdomain touches the owning *domain's* edge (and thus
        owns an MPI-level communication task in the paper's scheme)."""
        dims = range(self.box.ndim) if dim is None else [dim]
        for d in dims:
            lo = self.box.start[d] == self.domain_box.start[d]
            hi = self.box.stop[d] == self.domain_box.stop[d]
            if side == "lo" and lo:
                return True
            if side == "hi" and hi:
                return True
            if side is None and (lo or hi):
                return True
        return False

    def is_global_boundary(self, dim: Optional[int] = None) -> bool:
        dims = range(self.box.ndim) if dim is None else [dim]
        for d in dims:
            if self.box.start[d] == 0 or self.box.stop[d] == self.global_shape[d]:
                return True
        return False


@dataclass(frozen=True)
class Domain:
    """A process-level data partition (one mesh shard's slice of the global
    problem), created by applying `decompose_grid` at process level."""

    global_shape: Tuple[int, ...]
    box: Box                      # this rank's slice, global coordinates
    rank_index: Tuple[int, ...]   # position in the process grid
    process_grid: Tuple[int, ...]

    # ------------------------------------------------------------- factories
    @staticmethod
    def for_rank(global_shape: Sequence[int], process_grid: Sequence[int],
                 rank: int) -> "Domain":
        boxes = decompose_grid(global_shape, process_grid)
        assert 0 <= rank < len(boxes)
        idx = _unravel(rank, process_grid)
        return Domain(tuple(global_shape), boxes[rank], idx, tuple(process_grid))

    @staticmethod
    def all_ranks(global_shape: Sequence[int], process_grid: Sequence[int]) -> List["Domain"]:
        n = int(math.prod(process_grid))
        return [Domain.for_rank(global_shape, process_grid, r) for r in range(n)]

    # ------------------------------------------------- hierarchical reuse (§3.2)
    def over_decompose(self, sub_grid: Sequence[int]) -> List[SubDomain]:
        """Apply the SAME decomposition scheme one level down: the domain's
        local box is split by `decompose_grid` into task-level subdomains."""
        local_boxes = decompose_grid(self.box.shape, sub_grid)
        subs: List[SubDomain] = []
        for i, lb in enumerate(local_boxes):
            gb = lb.shifted(self.box.start)
            subs.append(
                SubDomain(
                    box=gb,
                    local_box=lb,
                    domain_box=self.box,
                    global_shape=self.global_shape,
                    index=_unravel(i, sub_grid),
                    grid=tuple(sub_grid),
                )
            )
        return subs

    def neighbors(self, periodic: bool = False) -> Dict[Tuple[int, str], Tuple[int, ...]]:
        """rank_index of the neighbor across each face, keyed by (dim, 'lo'|'hi')."""
        out: Dict[Tuple[int, str], Tuple[int, ...]] = {}
        for d in range(len(self.process_grid)):
            for side, delta in (("lo", -1), ("hi", +1)):
                idx = list(self.rank_index)
                idx[d] += delta
                if periodic:
                    idx[d] %= self.process_grid[d]
                elif not (0 <= idx[d] < self.process_grid[d]):
                    continue
                out[(d, side)] = tuple(idx)
        return out

    def halo_cells(self, width: int, dims: Optional[Sequence[int]] = None,
                   periodic: bool = False) -> int:
        return halo_cells(self.box, self.global_shape, width, dims, periodic)


def interior_boxes(shape: Sequence[int], width: int,
                   grid: Sequence[int], weights=None) -> List[Box]:
    """Task-level reuse of :func:`decompose_grid` on the INTERIOR of a local
    block: the cells [width, extent-width) per dim are split into a `grid` of
    chunk boxes (local-block coordinates). This is the 2-D over-decomposition
    the halo machinery feeds its interior chunk tasks from — the same
    partition function that cut the process mesh, one level down; the
    boundary strips (the halo consumers) are exactly the complement.

    `weights` (optional, one entry per dim, sized against the INTERIOR
    extent) produces the measured-cost uneven cut of :func:`split_ranges`;
    ``weights=None`` is bit-identical to the historical uniform grid."""
    inner = [max(0, e - 2 * width) for e in shape]
    shift = (width,) * len(tuple(shape))
    return [b.shifted(shift) for b in decompose_grid(inner, grid, weights)]


def interior_cuts(shape: Sequence[int], width: int, grid: Sequence[int],
                  weights=None) -> Tuple[Tuple[int, ...], ...]:
    """Canonical per-dim part extents of :func:`interior_boxes`' cut — the
    hashable cut descriptor the jitted-solver caches key on, so a rebalance
    that leaves the cut unchanged reuses the compiled program."""
    inner = [max(0, e - 2 * width) for e in shape]
    wts = _norm_weights(weights, len(inner))
    return tuple(part_extents(e, p, wd)
                 for e, p, wd in zip(inner, grid, wts))


def _unravel(i: int, grid: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for g in reversed(list(grid)):
        out.append(i % g)
        i //= g
    return tuple(reversed(out))


# ----------------------------------------------------------- Table 1 analytics
def halo_fraction(global_shape: Sequence[int], process_grid: Sequence[int],
                  width: int = 1) -> Tuple[int, int, float]:
    """Reproduces paper Table 1: total local data, total halo cells, and the
    paper's "% of data in halo" (= halo / data), summed over all ranks."""
    domains = Domain.all_ranks(global_shape, process_grid)
    data = sum(d.box.size for d in domains)
    halo = sum(d.halo_cells(width) for d in domains)
    return data, halo, halo / data
