"""``correct`` comes out false when the timed path is broken underneath,
and for the serving cell's control: the harness is driven below its look
for a chip, at the CPU's tiny size, with each fault a cell can have
planted (portbench/faults.py).

The limits here are the tiny size's own, set from its readings on seeds
11-13 (serving: widest joint gap 0.10-0.17, mean 0.007-0.011, maxval
0.14-0.22, points 1.6e-4-2.1e-4 mm; training: first loss 0.0008-0.0015,
median leaf 0.005-0.012, worst kernel 0.010-0.023, median change
0.003-0.008, worst change 0.033-0.062, median running average
0.033-0.044, median running average after the first step
0.0026-0.0029), with room above each: the cells' own limits are set at their
own sizes on the chip (PERF.md), where the training controls are held
too (test_portbench_card.py).
"""

from __future__ import annotations

import pytest
from portbench_tiny import run_tiny

from portbench import faults, harness

TINY_LIMITS = {"serve": {"joint_gap": 0.5, "joint_gap_mean": 0.05, "maxval_rel": 1.0,
                         "point_gap_mm": 0.01},
               "train": {"loss1_gap": 0.01, "grad_gap_median": 0.03, "grad_gap_kernels": 0.06,
                         "step_gap_median": 0.05, "step_gap": 0.2, "stats_gap_median": 0.12,
                         "stats1_gap_median": 0.01}}
SERVE, TRAIN = "serve.r50_256_fusion", ("train.r50_256_fusion", "train.r152_320_nofusion")


def _limits(cell):
    return TINY_LIMITS["serve" if cell == SERVE else "train"]


@pytest.mark.parametrize("cell", (SERVE,) + TRAIN)
def test_the_unbroken_path_is_correct(cell):
    rec = run_tiny(cell, seed=13, limits=_limits(cell))
    assert rec.correct, rec.compared


def _train_faults(cell):
    _, _, cfg = harness.cell_files(cell)
    return faults.train_faults(cfg)


@pytest.mark.parametrize("cell, fault", [(SERVE, f) for f in faults.SERVE]
                         + [(c, f) for c in TRAIN for f in _train_faults(c)])
def test_a_fault_underneath_is_not_correct(cell, fault):
    rec = run_tiny(cell, seed=13, limits=_limits(cell), fault=fault)
    assert rec.attempted > 0
    assert not rec.correct, rec.compared


def test_the_serving_control_is_not_correct():
    rec = run_tiny(SERVE, seed=13, limits=_limits(SERVE), variant="control")
    assert rec.attempted > 0
    assert not rec.correct, rec.compared


def test_the_program_int4_reading_runs_wider_at_4_bits():
    """The reading variant ``program_int4`` (the program's own 4-bit path,
    PERF.md section 4) builds and serves, and its served joints lie
    further below the reference's maxima than the program's defaults."""
    base = run_tiny(SERVE, seed=12, limits=_limits(SERVE))
    wide = run_tiny(SERVE, seed=12, limits=_limits(SERVE), variant="program_int4")
    assert wide.attempted > 0 and wide.failed == 0
    assert wide.compared["joint_gap_mean"][0] > base.compared["joint_gap_mean"][0]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_training_control_is_not_correct(cell):
    rec = run_tiny(cell, seed=13, limits=_limits(cell), variant="control")
    assert rec.attempted > 0
    assert not rec.correct, rec.compared
