"""The controls of the check. The control is the reference computed with
fp8 weight products, put in the program's place; each fault is planted
in the program's timed path. Both must come out not correct. On the CPU
at a small size; at the cell's own size on the card (marked ``gpu``)."""
import time

import pytest
import torch

from gpubench import bench, calibrate, check
from gpubench.tests._cells import cells, small_cell
from gpubench.workloads import train


@pytest.mark.parametrize("name", cells())
def test_control_reads_apart_from_the_program_small(name):
    """Over three seeds, one of the numbers reads at least three times
    higher in every control than in any run of the program."""
    cell = small_cell(name)
    seeds = (1, 2, 3)
    rows = [calibrate.readings(cell, s, "cpu", ("program", "control"))
            for s in seeds]
    prog = [r[0] for r in rows]
    ctrl = [r[1] for r in rows]
    apart = [n for n in check.NUMBERS
             if min(c[n] for c in ctrl) >= 3 * max(p[n] for p in prog)]
    assert apart, (prog, ctrl)


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
@pytest.mark.parametrize("name", cells())
def test_a_run_with_a_fault_is_not_correct(name, fault):
    """A whole run (the look for a card skipped) with the timed path
    broken underneath: the step returns its state unchanged, or leaves
    half of each batch out and takes the mean over the rest."""
    res = train.run(small_cell(name), 2**31 + 5, 0.3, False, "cpu",
                    time.perf_counter(), patch=calibrate.FAULTS[fault])
    assert not res["checks"]["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_control_fails_the_limits_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = bench.cell(name)
    for seed in (201, 202, 203):
        ref = train.reference(cell, seed, "cuda")
        train.free("cuda")
        ctrl = train.reference(cell, seed, "cuda", "fp8")
        train.free("cuda")
        assert not check.compare(ctrl, ref, cell["limits"])["correct"]
