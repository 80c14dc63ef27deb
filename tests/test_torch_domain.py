"""The port's partition scheme and cost model against the JAX package's.

``repro_torch.core.domain`` and ``repro_torch.core.cost`` are copies of the
JAX package's plain-Python modules; every cut, box, neighbour map and EMA
must be identical — these are integers and float sums in the same order, so
equality is exact. Cases are those of ``tests/test_domain.py`` and
``tests/test_rebalance.py``, plus seeded random weights from numpy.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import cost as jcost
from repro.core import domain as jdom
from repro_torch.core import cost as tcost
from repro_torch.core import domain as tdom


def _boxes(boxes):
    return [(b.start, b.stop) for b in boxes]


_RNG = np.random.default_rng(1234)
_RANDOM_W = [tuple(float(x) for x in _RNG.uniform(0.0, 10.0, e))
             for e in (8, 13, 32, 64)]

SPLIT_CASES = [
    (10, 3, None), (7, 3, None), (64, 8, None), (1, 1, None), (3, 5, None),
    (10, 3, (4, 3, 3)), (10, 2, (10, 0)), (16, 4, (1, 2, 3, 10)),
    (10, 3, [5.0] + [1.0] * 9),
    (32, 4, [4.0] * 8 + [1.0] * 24),
    (30, 4, [9.0] * 8 + [1.0] * 22),
    # flat and all-zero weights collapse onto the uniform cut
    (14, 4, [1.0] * 14), (30, 4, [2.5] * 30), (7, 3, [1.0] * 7),
    (16, 5, [2.5] * 16), (10, 3, [0.0] * 10),
    # uniform integer costs of the extent's length read as per-cell costs
    (6, 6, [1] * 6),
    (8, 3, _RANDOM_W[0]), (13, 4, _RANDOM_W[1]), (32, 5, _RANDOM_W[2]),
    (64, 8, _RANDOM_W[3]), (64, 1, _RANDOM_W[3]),
]


@pytest.mark.parametrize("extent,parts,weights", SPLIT_CASES)
def test_split_ranges_and_part_extents_match(extent, parts, weights):
    assert (tdom.split_ranges(extent, parts, weights)
            == jdom.split_ranges(extent, parts, weights))
    cut = tdom.part_extents(extent, parts, weights)
    assert cut == jdom.part_extents(extent, parts, weights)
    assert tdom.part_extents(extent, parts, cut) == cut  # a fixpoint


def test_flat_weights_collapse_to_uniform_bit_for_bit():
    for extent, parts in ((14, 4), (30, 4), (7, 3), (16, 5)):
        for c in (1.0, 2.5):
            assert (tdom.split_ranges(extent, parts, [c] * extent)
                    == tdom._split_extent(extent, parts)
                    == jdom._split_extent(extent, parts))


@pytest.mark.parametrize("args", [
    (10, 3, [1.0] * 7), (10, 3, [-1.0] + [1.0] * 9), (10, 2, (11, -1)),
    (10, 0, None)])
def test_split_validation_matches(args):
    with pytest.raises(ValueError):
        jdom.split_ranges(*args)
    with pytest.raises(ValueError):
        tdom.split_ranges(*args)


GRID_CASES = [
    ((16, 16), (4, 4), None), ((20, 18), (3, 2), None),
    ((17, 13), (3, 2), None), ((13, 11, 9), (3, 2, 2), None),
    ((64, 64), (4, 1), None), ((5, 5), (8, 8), None), ((7,), (3,), None),
    ((20, 18), (3, 2), ([5.0] * 20, None)),
    ((32, 16), (4, 2), (_RANDOM_W[2], (6, 10))),
]


@pytest.mark.parametrize("shape,parts,weights", GRID_CASES)
def test_decompose_grid_matches(shape, parts, weights):
    assert (_boxes(tdom.decompose_grid(shape, parts, weights))
            == _boxes(jdom.decompose_grid(shape, parts, weights)))


INTERIOR_CASES = [
    ((20, 18), 1, (3, 2), None),
    ((20, 18), 1, (3, 2), ([5.0] * 6 + [1.0] * 12, None)),
    ((17, 13), 2, (3, 2), None),
    ((13, 11, 9), 2, (3, 2, 2), None),
    ((32, 32), 1, (4, 4), ((3, 9, 9, 9), None)),
    ((34, 10), 1, (4, 1), (_RANDOM_W[2], None)),
]


@pytest.mark.parametrize("shape,width,grid,weights", INTERIOR_CASES)
def test_interior_boxes_and_cuts_match(shape, width, grid, weights):
    assert (_boxes(tdom.interior_boxes(shape, width, grid, weights))
            == _boxes(jdom.interior_boxes(shape, width, grid, weights)))
    assert (tdom.interior_cuts(shape, width, grid, weights)
            == jdom.interior_cuts(shape, width, grid, weights))


@pytest.mark.parametrize("entry,parts,extent", [
    ((4, 3, 3), 3, 10), ((4.0, 3.0, 3.0), 3, 10), ((4, 3, 2), 3, 10),
    ([1.5, 8.5], 2, 10), (5, 1, 5), ((1,) * 6, 6, 6)])
def test_is_extents_matches(entry, parts, extent):
    assert (tdom._is_extents(entry, parts, extent)
            == jdom._is_extents(entry, parts, extent))


@pytest.mark.parametrize("shape,pgrid,sgrid", [
    ((16, 16), (4, 4), (2, 2)), ((17, 13), (3, 2), (2, 3)),
    ((64, 64), (4, 1), (1, 4)), ((12, 10, 8), (2, 2, 2), (2, 1, 3))])
def test_domains_match(shape, pgrid, sgrid):
    tds = tdom.Domain.all_ranks(shape, pgrid)
    jds = jdom.Domain.all_ranks(shape, pgrid)
    assert len(tds) == len(jds)
    for t, j in zip(tds, jds):
        assert (t.box.start, t.box.stop) == (j.box.start, j.box.stop)
        assert t.rank_index == j.rank_index
        for periodic in (False, True):
            assert t.neighbors(periodic) == j.neighbors(periodic)
            assert (t.halo_cells(1, periodic=periodic)
                    == j.halo_cells(1, periodic=periodic))
        ts, js = t.over_decompose(sgrid), j.over_decompose(sgrid)
        assert ([(s.box.start, s.box.stop, s.index, s.is_boundary())
                 for s in ts]
                == [(s.box.start, s.box.stop, s.index, s.is_boundary())
                    for s in js])


@pytest.mark.parametrize("ranks", [2, 4, 8, 16, 32])
def test_halo_fraction_paper_table1_matches(ranks):
    assert (tdom.halo_fraction((128, 128), (ranks, 1), width=1)
            == jdom.halo_fraction((128, 128), (ranks, 1), width=1))


def _drive_cost(mod, records, ranges):
    cm = mod.CostModel(alpha=0.5)
    emas = [cm.record(k, s, cells=c) for k, s, c in records]
    return emas, cm.weights_along(ranges), cm.mean_rate(), len(cm)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_model_matches(seed):
    rng = np.random.default_rng(seed)
    ranges = [[(0, 5), (5, 12), (12, 16)], [(0, 4), (4, 10)]]
    records = []
    for _ in range(12):
        key = (int(rng.integers(0, 3)), int(rng.integers(0, 2)))
        records.append((key, float(rng.uniform(0.0, 5.0)),
                        int(rng.integers(1, 60))))
    assert (_drive_cost(tcost, records, ranges)
            == _drive_cost(jcost, records, ranges))


def test_cost_model_prior_and_validation():
    ranges = [[(0, 8), (8, 16)], [(0, 10)]]
    assert (tcost.CostModel().weights_along(ranges)
            == jcost.CostModel().weights_along(ranges))
    with pytest.raises(ValueError):
        tcost.CostModel(alpha=0.0)
    with pytest.raises(ValueError):
        tcost.CostModel().record("k", -1.0)
