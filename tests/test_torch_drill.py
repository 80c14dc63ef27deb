"""The port's live straggler drill and host-shard reassignment, mirroring
``tests/test_rebalance_system.py`` and ``tests/test_elastic.py`` with the
same thresholds.

The drill runs real OS processes (multiprocessing spawn, numpy-only
workers). A spawned worker imports the module that holds ``_drill_worker``;
that module must not import torch, or each of the four workers of each run
would pay for it.
"""
from __future__ import annotations

import multiprocessing as mp
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.runtime import rebalance as jreb
from repro.runtime.ft import reassign_host_shards as jreassign
from repro_torch.runtime import rebalance as treb
from repro_torch.runtime.ft import reassign_host_shards
from repro_torch.runtime.rebalance import (straggler_drill,
                                           straggler_drill_compare)

REPO = Path(__file__).resolve().parents[1]


def test_straggler_drill_dynamic_beats_static():
    """One worker slowed 3x: the measured-cost re-cut must shift rows away
    from the straggler and recover >= 1.2x throughput over the static
    uniform cut, without changing the numerics."""
    r = straggler_drill_compare(workers=4, rows=64, cols=64, steps=20,
                                warmup=4, rebalance_every=4, slow_worker=0,
                                slow_factor=3.0, seconds_per_cell=8e-6)
    st, dy = r["static"], r["dynamic"]
    assert r["speedup"] >= 1.2, r["speedup"]
    assert len(st["cut_history"]) == 1          # static never re-cuts
    assert len(dy["cut_history"]) >= 2          # dynamic did
    assert dy["extents"][0] < st["extents"][0]  # straggler's band shrank
    assert st["max_err"] < 1e-6 and dy["max_err"] < 1e-6
    # the straggler's measured per-cell rate is visibly the hot one
    assert dy["rates"][0] > 2.0 * dy["rates"][1]


def test_straggler_drill_worker_death_reassigns():
    """Killing a worker mid-run reroutes its band to a survivor via
    reassign_host_shards; the stitched field still matches the oracle."""
    d = straggler_drill(workers=4, rows=48, cols=32, steps=10, warmup=2,
                        rebalance_every=4, slow_worker=0, slow_factor=1.0,
                        seconds_per_cell=4e-6, dynamic=True,
                        fail_worker=2, fail_at_step=4)
    assert d["failed"] == [2]
    assert d["owner"][2] != 2           # the dead worker's band was rerouted
    assert d["owner"][2] in (0, 1, 3)
    assert d["max_err"] < 1e-6


def _worker_step(worker, band):
    """One band step of a drill worker, driven in a thread over a pipe."""
    conn, child = mp.Pipe()
    t = threading.Thread(target=worker, args=(child, 0, 0.0))
    t.start()
    conn.send(("step", band))
    out, _ = conn.recv()
    conn.send(("stop",))
    t.join(timeout=30)
    return out


@pytest.mark.parametrize("rows,cols,steps", [(64, 64, 20), (48, 32, 10)])
def test_drill_numerics_match_jax(rows, cols, steps):
    """The drill's grid, its oracle and one worker's band step are the JAX
    package's, bit for bit, at the drill tests' sizes: the bands of an
    uneven cut, halo rows as the drill builds them (zeros past the edge),
    stitch back into one oracle step."""
    u0 = treb._drill_init(rows, cols)
    np.testing.assert_array_equal(u0, jreb._drill_init(rows, cols))
    assert u0.dtype == np.float32
    np.testing.assert_array_equal(treb._jacobi_oracle(u0, steps),
                                  jreb._jacobi_oracle(u0, steps))
    u = treb._jacobi_oracle(u0, steps // 2)
    zero = np.zeros((1, cols), u.dtype)
    stitched = np.empty_like(u)
    for a, b in treb._extents_to_ranges([5, rows // 2 - 5, rows // 2]):
        band = np.concatenate([u[a - 1:a] if a > 0 else zero, u[a:b],
                               u[b:b + 1] if b < rows else zero])
        out = _worker_step(treb._drill_worker, band)
        np.testing.assert_array_equal(out,
                                      _worker_step(jreb._drill_worker, band))
        stitched[a:b] = out
    np.testing.assert_array_equal(stitched, jreb._jacobi_oracle(u, 1))


def test_drill_validation():
    with pytest.raises(ValueError, match="warmup"):
        straggler_drill(steps=4, warmup=4)
    with pytest.raises(ValueError, match="slow_worker"):
        straggler_drill(workers=2, slow_worker=5)
    with pytest.raises(ValueError, match="go together"):
        straggler_drill(fail_worker=1)


def test_drill_module_imports_no_torch():
    code = ("import sys; import repro_torch.runtime.rebalance; "
            "print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["False", "False"]


@pytest.mark.parametrize("n,failed", [(4, [2]), (8, [0, 7]), (5, [4, 1, 3]),
                                      (64, list(range(8))), (3, [])])
def test_reassignment_matches_jax(n, failed):
    plan = reassign_host_shards(n, failed)
    assert plan == jreassign(n, failed)
    served = sorted(s for slices in plan.values() for s in slices)
    assert served == list(range(n))
    loads = [len(v) for v in plan.values()]
    assert max(loads) - min(loads) <= 1


def test_reassignment_errors():
    with pytest.raises(RuntimeError, match="no surviving"):
        reassign_host_shards(4, [0, 1, 2, 3])
    with pytest.raises(ValueError, match="out of range"):
        reassign_host_shards(4, [4])
    with pytest.raises(ValueError, match="num_hosts"):
        reassign_host_shards(0, [])
