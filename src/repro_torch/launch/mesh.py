"""Process meshes over ``torch.distributed`` ranks.

The JAX package's mesh is a grid of devices under ``shard_map``; here it is
a grid of ranks. A :class:`ProcessMesh` names its axes, places this rank on
the grid (row-major over ranks), knows its neighbour ranks along each axis,
and holds one process group per axis line for the collectives. Functions,
not module constants, build it: importing this module touches no device and
starts no process group.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

GRID_AXES = ("rows", "cols")
GRID_AXES_3D = ("planes", "rows", "cols")


def resolve_device(device="cuda") -> torch.device:
    """The port's device contract: "cuda" unless the caller asks for the
    CPU. Asking for CUDA where there is none raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class ProcessMesh:
    """A named grid of ranks.

    ``shape`` maps axis name -> size (as ``jax.sharding.Mesh.shape`` does),
    ``coords`` is this rank's position, ``groups`` one process group per
    axis, holding the ranks of this rank's line along it (None where the
    axis has size 1, or the mesh has one rank), and one per tuple of axes
    asked of :meth:`axes_group`."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[str, Optional[object]] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> Tuple[int, ...]:
        return rank_coords(self.rank, self.sizes)

    def axis_index(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(
                f"mesh axes {self.axis_names} have no axis {name!r}")
        return self.axis_names.index(name)

    def axes_group(self, axes: Tuple[str, ...]):
        """One process group over the ranks that differ from this one only
        along `axes` (the sub-grid they span: with every DP axis, the
        data-parallel replicas), or None where that sub-grid is one rank.
        The first call for a set of axes is collective: every rank of the
        mesh must make it, in the same order (``dist.new_group``)."""
        axes = tuple(axes)
        ks = [self.axis_index(a) for a in axes]
        if math.prod(self.sizes[k] for k in ks) == 1:
            return None
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes not in self.groups:
            others = [range(s) if k not in ks else range(1)
                      for k, s in enumerate(self.sizes)]
            for base in itertools.product(*others):
                ranks = []
                for sub in itertools.product(*(range(self.sizes[k])
                                               for k in ks)):
                    c = list(base)
                    for k, i in zip(ks, sub):
                        c[k] = i
                    ranks.append(coords_rank(c, self.sizes))
                g = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self.groups[axes] = g
        return self.groups[axes]

    def neighbors(self, name: str, periodic: bool = False
                  ) -> Tuple[Optional[int], Optional[int]]:
        """(previous, next) rank along axis `name`; None past a
        non-periodic end."""
        k = self.axis_index(name)
        n = self.sizes[k]
        out = []
        for delta in (-1, 1):
            c = list(self.coords)
            c[k] += delta
            if periodic:
                c[k] %= n
            elif not 0 <= c[k] < n:
                out.append(None)
                continue
            out.append(coords_rank(c, self.sizes))
        return out[0], out[1]


def rank_coords(rank: int, sizes) -> Tuple[int, ...]:
    out = []
    for s in reversed(tuple(sizes)):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def coords_rank(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device="cuda") -> ProcessMesh:
    """A mesh of ``prod(shape)`` ranks named by `axes`. One rank needs no
    process group; any other size needs an initialised default group whose
    world size is ``prod(shape)``. Every rank must call this in the same
    order: it creates one group per axis line (``dist.new_group`` is
    collective)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes repeat a name: {axes}")
    dev = resolve_device(device)
    n = math.prod(shape)
    if n == 1:
        rank = dist.get_rank() if dist.is_initialized() else 0
        if dist.is_initialized() and dist.get_world_size() != 1:
            raise ValueError(
                f"mesh {shape} has one rank but the process group has "
                f"{dist.get_world_size()}")
        return ProcessMesh(axes, shape, rank, dev,
                           {a: None for a in axes})
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} spans {n} ranks: initialise torch.distributed "
            f"(init_process_group) first")
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {shape} needs {n} ranks, the process group has "
            f"{dist.get_world_size()}")
    rank = dist.get_rank()
    groups: Dict[str, Optional[object]] = {}
    for k, name in enumerate(axes):
        groups[name] = None
        if shape[k] == 1:
            continue
        # every line along axis k, in one fixed order on every rank
        others = [range(s) if j != k else range(1)
                  for j, s in enumerate(shape)]
        for base in itertools.product(*others):
            line = []
            for i in range(shape[k]):
                c = list(base)
                c[k] = i
                line.append(coords_rank(c, shape))
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    return ProcessMesh(axes, shape, rank, dev, groups)


def make_grid_mesh(*shape: int, axes: Optional[Tuple[str, ...]] = None,
                   device="cuda") -> ProcessMesh:
    """N-D process grid for hierarchical domain decomposition:
    ``make_grid_mesh(rows, cols)`` or ``make_grid_mesh(planes, rows, cols)``;
    size-1 axes keep the N-D code path on lower-dimensional layouts."""
    if axes is None:
        if len(shape) not in (2, 3):
            raise ValueError(f"make_grid_mesh default axes cover 2-D/3-D "
                             f"grids; got shape {shape} — pass axes=")
        axes = GRID_AXES if len(shape) == 2 else GRID_AXES_3D
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    return make_mesh(tuple(shape), tuple(axes), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ProcessMesh:
    """The reference's production mesh: ("data", "model") (16, 16), or
    with `multi_pod` ("pod", "data", "model") (2, 16, 16), over an
    initialised process group of 256 or 512 ranks (NCCL ranks, or the
    fake group of a dry run). Axis roles: "pod" the slowest hop (only
    gradient and MoE collectives cross it), "data" the DP/FSDP axis,
    "model" the TP/SP/EP axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def describe(mesh) -> str:
    return " x ".join(f"{n}={s}" for n, s in zip(mesh.axis_names,
                                                  mesh.sizes))


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.sizes)).get(name, 1)


def validate_production_mesh(mesh, *, multi_pod: bool) -> None:
    # a validator that compiles away under `python -O` validates nothing
    want = (2, 16, 16) if multi_pod else (16, 16)
    if tuple(mesh.sizes) != want:
        raise ValueError(f"production mesh must be {want}, "
                         f"got {tuple(mesh.sizes)}")
    if math.prod(mesh.sizes) != (512 if multi_pod else 256):
        raise ValueError(f"production mesh has {math.prod(mesh.sizes)} "
                         f"devices")
