"""The two cells of xDeepFM and fp32 batch scoring, at tiny shapes on the CPU:
the plain reference against the program through the xDeepFM door, ``correct``
under each new cell's limits for the program and not for the control or a
planted fault, the loop's own traced stretch, and the counts of
``cin_roofline.py`` pinned to the configuration's shapes by hand."""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from port_bench import cin_roofline, faults, generator, program, run, xdeepfm
from port_bench.reference import xdeepfm as ref_xdeepfm
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")
TRAIN, SERVE = "criteo_xdeepfm_train_b4096", "criteo_serve_fp32_b8192"


def _data(name):
    return json.loads((HERE / "data" / f"{name}.json").read_text())


def _spec(cell):
    if cell == TRAIN:
        config, traffic = _data("tiny_xdeepfm"), _data("tiny_train_xdeepfm")
    else:
        config, traffic = _data("tiny_criteo"), {**_data("tiny_serve_int8"), "precision": "fp32"}
    return {"config": config, "traffic": traffic,
            "limits": json.loads((ROOT / "port_bench" / "limits" / f"{cell}.json").read_text())}


def _rows(cfg, n, seed=11):
    tr = {"zipf_a": 1.05, "min_count": 4}
    xi, xv, y = generator.sample_rows(cfg, tr, n, seed, CPU)
    return torch.from_numpy(xi), torch.from_numpy(xv), torch.from_numpy(y)


def _program(cfg, seed=5):
    w = xdeepfm.make(cfg, seed, CPU)
    mcfg = xdeepfm.model_config(cfg)
    return w, mcfg, program.params(mcfg, {k: v.clone() for k, v in w.items()})


def test_the_forward_matches_the_programs():
    cfg = _data("tiny_xdeepfm")
    w, mcfg, params = _program(cfg)
    xi, xv, _ = _rows(cfg, 300)
    got = deepfwfm.forward(params, xi, xv, mcfg, lookup_fn=packed_lookup_serving)
    want = ref_xdeepfm.forward(w, cfg, xi, xv)
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    # the CIN's term is a share of the logit the comparison sees
    w_off = {**w, "cin/fc_w": torch.zeros_like(w["cin/fc_w"])}
    assert float((ref_xdeepfm.forward(w_off, cfg, xi, xv) - want).abs().max()) > 0.1


def test_the_training_forward_draws_the_programs_dropout():
    cfg = _data("tiny_xdeepfm")
    w, mcfg, params = _program(cfg)
    xi, xv, _ = _rows(cfg, 64)
    got = deepfwfm.forward(params, xi, xv, mcfg, train=True,
                           generator=torch.Generator().manual_seed(3))
    want = ref_xdeepfm.forward(w, cfg, xi, xv, gen=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_three_steps_match_the_programs_train_step():
    cfg = _data("tiny_xdeepfm")
    tr = {"batch": 64, "prune": 0, "steps_per_call": 1}
    w, mcfg, params = _program(cfg)
    tcfg = xdeepfm.train_config(cfg, tr)
    opt = make_optimizer(tcfg)
    state = opt.init(params)
    step = make_train_step(mcfg, tcfg, opt)
    xi, xv, y = _rows(cfg, 3 * 64)
    batches = [{"xi": xi[i * 64:(i + 1) * 64], "xv": xv[i * 64:(i + 1) * 64],
                "y": y[i * 64:(i + 1) * 64]} for i in range(3)]
    gen = torch.Generator().manual_seed(9)
    losses = [float(step(params, state, {**b, "mask": torch.ones(64)}, gen)) for b in batches]
    ref = ref_xdeepfm.steps(w, cfg, batches, torch.Generator().manual_seed(9))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = program.named(params)
    assert set(got) == set(w)
    for k, v in w.items():
        np.testing.assert_allclose(float((got[k] - v).double().norm()), ref["change"][k],
                                   rtol=1e-3, atol=1e-9)


def _correct(cell, seed, control=False, trace=False):
    rec, ctx = run.run_spec(_spec(cell), cell, seed, 0.3, trace, CPU, time.perf_counter(),
                            control=control)
    return run.judge(rec.checks, ctx.limits) and rec.failed == 0, rec, ctx


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_the_program_is_correct_and_the_control_is_not(cell):
    ok, rec, ctx = _correct(cell, 2 ** 31 + 3, control=True)
    assert ok, rec.checks
    assert set(rec.control_checks) == set(ctx.limits)
    assert any(v > ctx.limits[k] for k, v in rec.control_checks.items()), rec.control_checks


@pytest.mark.parametrize("cell, fault", [(TRAIN, "half_batch"), (TRAIN, "state_unchanged"),
                                         (TRAIN, "answer_altered_loss"),
                                         (SERVE, "answer_altered"), (SERVE, "half_answer")])
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        ok, rec, ctx = _correct(cell, 2 ** 31 + 5)
    assert set(rec.checks) == set(ctx.limits)
    assert not ok and any(v > ctx.limits[k] for k, v in rec.checks.items()), rec.checks


def test_a_traced_run_keeps_its_own_spans():
    ok, rec, ctx = _correct(TRAIN, 2 ** 33 + 1, trace=True)
    assert ok, rec.checks
    names = {s.name for s in rec.program_spans}
    assert {"CIN - Component", "CIN - Layer 3", "step.forward", "train.step",
            "feed.stage"} <= names
    line = run.result_line(json.loads((ROOT / "BENCHMARK.json").read_text()), rec, ctx)
    # the CPU has no device spans: the CIN's device metrics are left out, the host's read
    assert "train_host_ms" in line["metrics"] and "cin_device_ms" not in line["metrics"]
    assert line["metrics"]["mfu_pct.xdeepfm_train"]["value"] > 0


CONFIG = json.loads((ROOT / "port_bench" / "configs" / "xdeepfm_criteo.json").read_text())


def test_the_counts_at_the_configurations_shapes():
    # CIN: 2 * 10 * (39*39*200 + 200*39*200 + 200*39*200)
    assert (cin_roofline.cin_flops(CONFIG) == 2 * 10 * (304_200 + 1_560_000 + 1_560_000)
            == 68_484_000)
    # DNN: 2 * (390*400 + 400*400); heads: 2 * (600 + 400)
    assert cin_roofline.dnn_flops(CONFIG) == 632_000 and cin_roofline.head_flops(CONFIG) == 2_000
    assert cin_roofline.forward_flops(CONFIG) == 69_118_000
    assert cin_roofline.train_step_flops(CONFIG, 4096) == 3 * 69_118_000 * 4096
    # tables 1,326,055 * 11; CIN 3,424,200 + 600; DNN 156,400 + 160,400 + 400; bias
    assert cin_roofline.param_count(CONFIG) == 18_328_606 == CONFIG["parameters"]
    assert 1 + sum(int(np.prod(s)) for _, s, _ in xdeepfm.layout(CONFIG)) == 18_328_606
    # X0 6,389,760 B, W 13,696,800 B, X^1..3 written 98,304,000 B, X^1, X^2 read 65,536,000 B
    assert cin_roofline.cin_bytes(CONFIG, 4096) == 183_926_560
    assert cin_roofline.cin_least_seconds(CONFIG, 4096) == pytest.approx(4.1867e-3, rel=1e-4)
