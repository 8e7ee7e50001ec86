"""``criteo_train_k10`` (``loops/train_multi_step.py``) at tiny shapes on the
CPU: the epoch's groups, the padded last one included, ``correct`` under the
cell's limits for the program and not for the TF32 control or a planted fault,
and the cell's entry in ``BENCHMARK.json``. The tiny configuration takes the
cell's E=10 and a tower of 128 (at E=4 and 16 the TF32 control's roundings stay
within the cell's limits), and its refresh schedule runs faster (``prune_omega``
1, so that the first group's refresh prunes 8.6% of each group where the
configuration's prunes 0.09%), so that a skipped refresh shows at a few
thousand values."""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from port_bench import faults, run
from port_bench.loops import train_multi_step

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")
CELL = "criteo_train_k10"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAFFIC = json.loads((ROOT / "port_bench" / "traffic" / "train_k10_prune.json").read_text())


def _spec():
    cfg = {**json.loads((HERE / "data" / "tiny_criteo.json").read_text()), "prune_omega": 1.0,
           "embedding_size": 10, "deep_nodes": 128}
    return {"config": cfg, "traffic": {**TRAFFIC, "batch": 64, "pool_rows": 4096},
            "limits": json.loads((ROOT / "port_bench" / "limits" / f"{CELL}.json").read_text())}


def _run(seed, control=False, trace=False):
    rec, ctx = run.run_spec(_spec(), CELL, seed, 0.2, trace, CPU, time.perf_counter(),
                            control=control)
    return run.judge(rec.checks, ctx.limits) and rec.failed == 0, rec, ctx


def test_an_epoch_is_its_full_groups_then_the_padded_one():
    n, b, k = 64 * 65, 64, 10
    xi = np.arange(n, dtype=np.int32)[:, None]
    groups = train_multi_step._epochs(xi, np.zeros((n, 1), np.float32),
                                      np.zeros(n, np.float32), b, k)
    got = [next(groups) for _ in range(14)]
    assert [g["k_real"] for g in got] == [10] * 6 + [5] + [10] * 6 + [5]
    assert got[6]["xi"].shape == (10, 64, 1) and got[6]["mask"][5:].sum() == 0
    assert int(got[7]["xi"][0, 0, 0]) == 0          # the next epoch from the pool's start


@pytest.mark.parametrize("seed", [2 ** 31 + 41, 2 ** 33 + 43])
def test_the_program_is_correct_and_the_control_is_not(seed):
    ok, rec, ctx = _run(seed, control=True)
    assert ok, rec.checks
    assert set(rec.checks) == set(ctx.limits) == set(rec.control_checks)
    assert any(v > ctx.limits[k] for k, v in rec.control_checks.items()), rec.control_checks
    assert len(rec.info["first_losses"]) == 10 and rec.info["calls_a_epoch"] == 7
    assert rec.attempted > 0 and rec.examples == 64 * rec.attempted


@pytest.mark.parametrize("fault", ["refresh_skipped", "half_batch", "state_unchanged"])
def test_a_planted_fault_is_not_correct(fault):
    with faults.plant(fault):
        ok, rec, ctx = _run(2 ** 31 + 47)
    assert set(rec.checks) == set(ctx.limits)
    assert not ok and any(v > ctx.limits[k] for k, v in rec.checks.items()), rec.checks


def test_the_cell_is_fit_at_ten_steps_a_call():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "deepfwfm_criteo", "train_k10_prune", 1)
    base = json.loads((ROOT / "port_bench" / "traffic" / "train_per_batch_prune.json").read_text())
    assert {k: v for k, v in TRAFFIC.items() if k not in ("loop", "steps_per_call", "assumed")} == {
        k: v for k, v in base.items() if k not in ("loop", "steps_per_call", "assumed")}
    assert TRAFFIC["steps_per_call"] == 10 and TRAFFIC["pool_rows"] // TRAFFIC["batch"] == 512
    reported = {m["name"] for m in run.metrics_of(BENCH, CELL, True)}
    assert reported == {"feed_wait_ms", "device_idle_pct.train", "mfu_pct.train",
                        "step_forward_device_ms", "step_backward_device_ms",
                        "step_optimizer_device_ms", "multi_step_device_ms",
                        "multi_step_host_ms"}


def test_a_traced_run_reads_the_groups_per_step():
    """The host's ms are of the traced stretch's real steps, the padded group's
    two included; the device's ms are the window's events over its steps (none
    on the CPU, so nothing is read there)."""
    ok, rec, ctx = _run(2 ** 31 + 53, trace=True)
    assert ok, rec.checks
    calls = train_multi_step.PROFILED_STEPS
    assert 5 * (calls - 1) < rec.info["traced_stretch_steps"] <= 10 * calls
    line = run.result_line(BENCH, rec, ctx)
    host = line["metrics"]["multi_step_host_ms"]["value"]
    spans = [s for s in rec.program_spans if s.name == "train.step"]
    assert len(spans) == calls and 0 < host
    assert "multi_step_device_ms" not in line["metrics"] and not rec.device_ms["multi_step"]
    fake = type("R", (), {"device_ms": {"multi_step": [9.0, 9.0, 3.0]}, "attempted": 22})()
    assert run.reader("multi_step_device_ms", True)(fake, ctx) == pytest.approx(21.0 / 22)
