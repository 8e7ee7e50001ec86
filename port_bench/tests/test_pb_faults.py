"""``correct`` under each cell's own limits: true for the program as it is,
false for the control (the reference one precision down, in the program's
place) and for every fault a cell can have, planted underneath the timed
path. Tiny shapes on the CPU; ``calibrate.py`` reads the same on the card at
the cells' sizes."""

import json
import pathlib
import time

import pytest
import torch

from port_bench import faults, run

HERE = pathlib.Path(__file__).resolve().parent
LIMITS = HERE.parents[0] / "limits"
CPU = torch.device("cpu")

# (cell whose limits judge, tiny configuration, tiny traffic, faults the cell can have)
CELLS = {
    "criteo_train_prune": ("tiny_criteo", "tiny_train_prune",
                           ("state_unchanged", "half_batch", "answer_altered_loss",
                            "refresh_skipped")),
    "avazu_train_dense": ("tiny_avazu", "tiny_train_dense",
                          ("state_unchanged", "half_batch", "answer_altered_loss")),
    "criteo_serve_int8_b8192": ("tiny_criteo", "tiny_serve_int8",
                                ("answer_altered", "half_answer")),
    "avazu_serve_fp32_b1": ("tiny_avazu", "tiny_serve_fp32", ("answer_altered",)),
}


def _spec(cell):
    config, mix, _ = CELLS[cell]
    traffic = (json.loads((HERE / "data" / "tiny_train_prune.json").read_text()) | {"prune": 0}
               if mix == "tiny_train_dense"
               else json.loads((HERE / "data" / f"{mix}.json").read_text()))
    return {"config": json.loads((HERE / "data" / f"{config}.json").read_text()),
            "traffic": traffic,
            "limits": json.loads((LIMITS / f"{cell}.json").read_text())}


def _correct(cell, seed, control=False):
    rec, ctx = run.run_spec(_spec(cell), cell, seed, 0.3, False, CPU, time.perf_counter(),
                            control=control)
    return run.judge(rec.checks, ctx.limits) and rec.failed == 0, rec


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_program_is_correct_and_the_control_is_not(cell):
    ok, rec = _correct(cell, 2 ** 31 + 3, control=True)
    assert ok, rec.checks
    limits = _spec(cell)["limits"]
    assert rec.control_checks and set(rec.control_checks) <= set(limits)
    assert any(v > limits[k] for k, v in rec.control_checks.items()), rec.control_checks


@pytest.mark.parametrize("cell, fault", [(c, f) for c, (_, _, fs) in sorted(CELLS.items())
                                         for f in fs])
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        ok, rec = _correct(cell, 2 ** 31 + 5)
    limits = _spec(cell)["limits"]
    assert set(rec.checks) == set(limits)          # every number made: one of them fails
    assert not ok and any(v > limits[k] for k, v in rec.checks.items()), rec.checks
