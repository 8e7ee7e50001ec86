"""DLRM-DCNv2's cell and the Avazu pruning cell, at tiny shapes on the CPU: the
loop through the model's door, the plain reference's compact table against
its full one, ``correct`` under the cell's limits for the program and not for
the TF32 control or a planted fault, the counts of ``dlrm_roofline.py`` at the
configuration's shapes, the configuration's cut, and the prune-targets loop."""

import contextlib
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from port_bench import dlrm, dlrm_faults, dlrm_roofline, program, run
from port_bench.loops import train_per_batch
from port_bench.reference import dlrm_dcnv2 as ref
from xsdeepfwfm_deprecated_torch.models import dlrm as program_dlrm

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")
CELL, PRUNE = "criteo1tb_dlrm_dcnv2_train_b8192", "avazu_train_prune"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "dlrm_dcnv2_criteo1tb.json").read_text())


def _data(name):
    return json.loads((HERE / "data" / f"{name}.json").read_text())


def _spec():
    return {"config": _data("tiny_dlrm"), "traffic": _data("tiny_train_dlrm"),
            "limits": json.loads((ROOT / "port_bench" / "limits" / f"{CELL}.json").read_text())}


def _correct(seed, control=False, trace=False):
    rec, ctx = run.run_spec(_spec(), CELL, seed, 0.3, trace, CPU, time.perf_counter(),
                            control=control)
    return run.judge(rec.checks, ctx.limits) and rec.failed == 0, rec, ctx


def test_the_forward_matches_the_programs():
    cfg = _data("tiny_dlrm")
    w = dlrm.make(cfg, 5, CPU)
    mcfg = dlrm.model_config(cfg)
    params = dlrm.params(mcfg, {k: v.clone() for k, v in w.items()})
    xi, xv, _ = dlrm.sample_rows(cfg, _data("tiny_train_dlrm"), 300, 11, CPU)
    xi, xv = torch.from_numpy(xi), torch.from_numpy(xv)
    got = program_dlrm.forward(params, xi, xv, mcfg)
    want = ref.forward(w, cfg, ref.packed_rows(cfg, xi), xv)
    assert float(want.std()) > 0.05
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    # the bags move the logit by a share the comparison sees
    w_off = {**w, ref.TABLE: torch.zeros_like(w[ref.TABLE])}
    assert float((ref.forward(w_off, cfg, ref.packed_rows(cfg, xi), xv) - want).abs().max()) > 0.01


def test_the_sampled_bags_keep_to_their_fields():
    cfg = _data("tiny_dlrm")
    xi, _, _ = dlrm.sample_rows(cfg, _data("tiny_train_dlrm"), 2000, 3, CPU)
    assert xi.shape == (2000, sum(cfg["bag_sizes"]))
    at = 0
    for size, k in zip(cfg["feature_sizes"][cfg["numerical"]:], cfg["bag_sizes"]):
        assert xi[:, at:at + k].min() >= 0 and xi[:, at:at + k].max() < size
        at += k


def test_the_compact_tables_steps_are_the_full_tables():
    cfg = _data("tiny_dlrm")
    w = dlrm.make(cfg, 7, CPU)
    xi, xv, y = dlrm.sample_rows(cfg, _data("tiny_train_dlrm"), 3 * 64, 13, CPU)
    batches = [{"rows": ref.packed_rows(cfg, torch.from_numpy(xi[i * 64:(i + 1) * 64])),
                "xv": torch.from_numpy(xv[i * 64:(i + 1) * 64]),
                "y": torch.from_numpy(y[i * 64:(i + 1) * 64])} for i in range(3)]
    full = ref.steps(w, cfg, batches)
    w_c, batches_c, touched = ref.compact(w, batches)
    assert w_c[ref.TABLE].shape[0] == touched.numel() < w[ref.TABLE].shape[0]
    small = ref.steps(w_c, cfg, batches_c)
    np.testing.assert_allclose(small["losses"], full["losses"], rtol=1e-6)
    for k in full["grad"]:
        assert small["grad"][k] == pytest.approx(full["grad"][k], rel=1e-6), k
        assert small["change"][k] == pytest.approx(full["change"][k], rel=1e-6), k


def test_the_program_is_correct_and_the_control_is_not():
    ok, rec, ctx = _correct(2 ** 31 + 3, control=True)
    assert ok, rec.checks
    assert rec.info["rows_updated"][0] == rec.info["rows_updated"][1] > 0
    assert set(rec.control_checks) == set(ctx.limits)
    assert any(v > ctx.limits[k] for k, v in rec.control_checks.items()), rec.control_checks


@pytest.mark.parametrize("fault", ["bag_duplicates_unsummed", "bag_update_skipped",
                                   "half_batch", "answer_altered_loss", "state_unchanged"])
def test_a_planted_fault_is_not_correct(fault):
    with dlrm_faults.plant(fault):
        ok, rec, ctx = _correct(2 ** 31 + 5)
    assert set(rec.checks) == set(ctx.limits)
    assert not ok and any(v > ctx.limits[k] for k, v in rec.checks.items()), rec.checks


def test_a_traced_run_keeps_its_own_spans():
    ok, rec, ctx = _correct(2 ** 33 + 1, trace=True)
    assert ok, rec.checks
    names = {s.name for s in rec.program_spans}
    assert {"Bags - Lookup", "Bags - Update", "DCN - Component", "DCN - Layer 2",
            "step.optimizer", "train.step", "feed.stage"} <= names
    assert rec.info["bag_distinct_rows"] > 0
    line = run.result_line(BENCH, rec, ctx)
    # the CPU has no device spans: the device metrics are left out, the host's read
    assert "train_host_ms" in line["metrics"] and "dcn_device_ms" not in line["metrics"]
    assert line["metrics"]["mfu_pct.dlrm_train"]["value"] > 0
    assert {m["name"] for m in run.metrics_of(BENCH, CELL, True)} >= {
        "dcn_device_ms", "dcn_roofline", "bag_lookup_device_ms", "bag_lookup_roofline",
        "bag_update_device_ms", "bag_update_roofline", "mfu_pct.dlrm_train"}


def test_the_counts_at_the_configurations_shapes():
    # per example: dense arch 13*512 + 512*256 + 256*128; cross 3 * 2 * 3456*512;
    # over arch 3456*1024 + 1024*1024 + 1024*512 + 512*256 + 256*1
    assert dlrm_roofline.dense_arch_macs(CONFIG) == 170_496
    assert dlrm_roofline.cross_macs(CONFIG) == 10_616_832
    assert dlrm_roofline.over_arch_macs(CONFIG) == 5_243_136
    assert dlrm_roofline.forward_flops(CONFIG) == 32_060_928
    assert dlrm_roofline.train_step_flops(CONFIG, 8192) == 787_929_366_528
    assert dlrm_roofline.dcn_least_seconds(CONFIG, 8192) == pytest.approx(2.5962e-3, rel=1e-4)
    # ids 8192 * 214 * 4 B; pooled 8192 * 26 * 512 B; a distinct row 512 B (4 of them to update)
    assert dlrm_roofline.ids(CONFIG, 8192) == 1_753_088
    assert dlrm_roofline.lookup_bytes(CONFIG, 8192, 1_000_000) == (
        7_012_352 + 512 * 1_000_000 + 109_051_904)
    assert dlrm_roofline.update_bytes(CONFIG, 8192, 1_000_000) == (
        109_051_904 + 2048 * 1_000_000 + 7_012_352)
    # the table (26,500,127 rows x 128), the arches with their biases, 3 cross layers
    assert dlrm_roofline.param_count(CONFIG) == 3_408_060_801 == CONFIG["parameters"]
    assert sum(int(np.prod(s)) for _, s, _ in dlrm.layout(CONFIG)) == 3_408_060_801


def test_the_configuration_states_its_cut():
    held, published = CONFIG["feature_sizes"][13:], CONFIG["published_feature_sizes"][13:]
    assert sum(held) == CONFIG["rows_held"] == 26_500_127
    assert sum(published) == CONFIG["rows_published"] == 204_184_588
    divided = [f"feature_sizes.C{i + 1}" for i, (h, p) in enumerate(zip(held, published)) if h != p]
    entry = next(c for c in BENCH["configs"] if c["name"] == "dlrm_dcnv2_criteo1tb")
    assert divided == CONFIG["reduced"] == entry["reduced"]
    assert all(h == -(-p // 8) for h, p in zip(held, published) if h != p)
    assert sum(CONFIG["bag_sizes"]) == 214 and CONFIG["embedding_size"] == 128
    # 27.14 GB of table and accumulator
    assert 2 * 4 * 128 * sum(held) == pytest.approx(27.14e9, rel=1e-3)


def test_the_prune_targets_loop_gives_train_per_batch_the_overlaid_keys(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_per_batch, "run", lambda ctx: seen.setdefault("ctx", ctx))
    traffic = json.loads((ROOT / "port_bench" / "traffic" /
                          "train_per_batch_prune_avazu.json").read_text())
    spec = run.cell_spec(BENCH, PRUNE)
    assert spec["traffic"] == traffic and spec["config"]["model"] == "DeepFwFM"
    run.run_spec(spec, PRUNE, 1, 0.1, False, CPU, time.perf_counter())
    ctx = seen["ctx"]
    assert ctx.traffic["loop"] == "train_per_batch" and "prune_targets" not in ctx.traffic
    assert {k: ctx.config[k] for k in traffic["prune_targets"]} == traffic["prune_targets"]
    assert ctx.config["sparse"] == 0.98 and ctx.config["prune_fm"] is False
    tcfg = program.train_config(ctx.config, ctx.traffic)
    assert (tcfg.sparse, tcfg.emb_corr, tcfg.prune_r, tcfg.prune_fm, tcfg.prune) == (
        0.98, 0.918367, True, False, True)


def _prune_spec():
    traffic = json.loads((ROOT / "port_bench" / "traffic" /
                          "train_per_batch_prune_avazu.json").read_text())
    return {"config": _data("tiny_avazu"), "traffic": {**traffic, "batch": 64, "pool_rows": 4096},
            "limits": json.loads((ROOT / "port_bench" / "limits" / f"{PRUNE}.json").read_text())}


@pytest.mark.parametrize("fault", [None, "refresh_skipped", "half_batch"])
def test_the_pruning_cell_is_correct_and_its_control_and_faults_are_not(fault):
    with dlrm_faults.plant(fault) if fault else contextlib.nullcontext():
        rec, ctx = run.run_spec(_prune_spec(), PRUNE, 2 ** 31 + 9, 0.3, False, CPU,
                                time.perf_counter(), control=fault is None)
    ok = run.judge(rec.checks, ctx.limits) and rec.failed == 0
    assert ok == (fault is None), rec.checks
    assert ctx.config["sparse"] == 0.98 and "refresh_gap" in rec.checks
    if fault is None:           # the control runs no refresh: its refresh_gap is not judged
        assert any(v > ctx.limits[k] for k, v in rec.control_checks.items())
