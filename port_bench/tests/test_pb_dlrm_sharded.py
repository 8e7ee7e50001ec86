"""DLRM-DCNv2 whole over four ranks (``loops/train_dlrm_sharded.py``), at tiny
shapes on the CPU over gloo: one start of the ranks runs every case (seeds, a
traced run and the four faults of ``dlrm_sharded_faults.py``); the test
process makes each record as the loop does, the reference included. Beside
them: the chunked weights, the hashed traffic, the counts of
``dlrm_sharded_roofline.py`` at the configuration's shapes, the blocked
reference against the straight one, and the configuration itself."""

import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from port_bench import dlrm, dlrm_sharded_faults, dlrm_sharded_roofline, dlrm_whole, run
from port_bench.harness import Context
from port_bench.loops import train_dlrm_sharded as loop
from port_bench.reference import dlrm_dcnv2 as ref
from port_bench.reference import dlrm_dcnv2_blocks as ref_blocks
from xsdeepfwfm_deprecated_torch.ops.embedding import bag_spec
from xsdeepfwfm_deprecated_torch.parallel import bag_sharding

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CPU = torch.device("cpu")
CELL = "criteo1tb_dlrm_dcnv2_train_4card_b65536"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "dlrm_dcnv2_criteo1tb_whole.json")
                    .read_text())
ONE_CARD = json.loads((ROOT / "port_bench" / "configs" / "dlrm_dcnv2_criteo1tb.json").read_text())
LIMITS = json.loads((ROOT / "port_bench" / "limits" / f"{CELL}.json").read_text())
SEEDS = (2 ** 33 + 3, 2 ** 31 + 17)
TRACED = 2 ** 32 + 5
FAULT_SEED = 2 ** 31 + 29


def _data(name):
    return json.loads((HERE / "data" / f"{name}.json").read_text())


def _ctx(seed, trace=False, control=False):
    return Context(cell=CELL, config=_data("tiny_dlrm_whole"), traffic=_data("tiny_train_dlrm_rw4"),
                   seed=seed, seconds=0.3, trace=trace, device=CPU, limits=LIMITS,
                   started=time.perf_counter(), control=control)


CASES = ([(_ctx(s, control=True), None) for s in SEEDS] + [(_ctx(TRACED, trace=True), None)]
         + [(_ctx(FAULT_SEED), f) for f in dlrm_sharded_faults.FAULTS])


@pytest.fixture(scope="module")
def records():
    ranks = loop.start([loop.jobs_of(ctx, fault) for ctx, fault in CASES], CPU)
    return {(ctx.seed, fault): (loop.finish(ctx, [r[i] for r in ranks]), ctx)
            for i, (ctx, fault) in enumerate(CASES)}


def _correct(rec, ctx):
    return run.judge(rec.checks, ctx.limits) and rec.failed == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_is_correct_and_the_control_is_not(records, seed):
    rec, ctx = records[(seed, None)]
    assert _correct(rec, ctx), rec.checks
    assert set(rec.checks) == set(LIMITS) == set(rec.control_checks)
    assert any(v > LIMITS[k] for k, v in rec.control_checks.items()), rec.control_checks
    assert all(p == h > 0 for p, h in rec.info["rows_updated"])
    assert rec.examples == rec.attempted * 4 * ctx.traffic["batch"] and rec.attempted > 0
    assert [r["exchange_bytes"] > 0 for r in rec.info["ranks"]] == [True] * 4


@pytest.mark.parametrize("fault", dlrm_sharded_faults.FAULTS)
def test_a_planted_fault_is_not_correct(records, fault):
    rec, ctx = records[(FAULT_SEED, fault)]
    assert set(rec.checks) == set(LIMITS)
    assert not _correct(rec, ctx) and any(v > LIMITS[k] for k, v in rec.checks.items()), (
        rec.checks)


def test_a_traced_run_reports_its_metrics(records):
    rec, ctx = records[(TRACED, None)]
    assert _correct(rec, ctx), rec.checks
    names = {s.name for s in rec.program_spans}
    assert {"Bags - Ids Exchange", "Bags - Lookup", "Bags - Pool Exchange", "Bags - Grad Exchange",
            "Bags - Update", "Dense - All Reduce", "DCN - Component", "train.step",
            "feed.stage"} <= names
    line = run.result_line(BENCH, rec, ctx)
    # the CPU has no device spans: the device metrics are left out, the host's read
    assert "train_host_ms" in line["metrics"] and "bag_exchange_device_ms" not in line["metrics"]
    assert line["metrics"]["mfu_pct.dlrm_train"]["value"] > 0
    assert {m["name"] for m in run.metrics_of(BENCH, CELL, True)} >= {
        "bag_exchange_device_ms", "bag_exchange_roofline", "dense_allreduce_device_ms",
        "mfu_pct.dlrm_train", "dcn_device_ms", "bag_update_device_ms", "feed_wait_ms"}
    assert not {"bag_lookup_roofline", "bag_update_roofline"} & {
        m["name"] for m in run.metrics_of(BENCH, CELL, True)}
    assert len(rec.info["ranks"]) == 4 and rec.traced_units == loop.PROFILED_STEPS


def test_the_line_counts_the_cards_the_ranks_ran_on(records, monkeypatch):
    rec, ctx = records[(SEEDS[0], None)]
    assert loop.cards_used(rec) is None and "cards" not in rec.info       # the CPU holds none
    monkeypatch.setattr(run, "result_line", run.result_line)               # put back after
    loop.count_cards_in_line()
    once = run.result_line
    loop.count_cards_in_line()
    assert run.result_line is once and once.counts_cards
    assert run.result_line(BENCH, rec, ctx)["device"]["count"] == 1
    cards = [{"index": r, "name": "card", "uuid": f"GPU-{r}"} for r in range(4)]
    carded = dataclasses.replace(rec, info={**rec.info, "cards": cards})
    assert run.result_line(BENCH, carded, ctx)["device"]["count"] == 4
    # ranks that shared a card are no run of four cards
    shared = [{"t0": ctx.started, "window_s": 1.0, "steps": 1, "failed": 0, "memory": {},
               "card": cards[min(r, 2)]} for r in range(4)]
    with pytest.raises(ValueError, match="3 distinct"):
        loop.finish(ctx, shared)


def test_the_chunked_table_draws_any_rows_alike(monkeypatch):
    cfg = _data("tiny_dlrm_whole")
    monkeypatch.setattr(dlrm_whole, "CHUNK", 100)
    rows = dlrm_whole.TableRows(cfg, 7, CPU)
    whole = rows(0, dlrm.table_rows(cfg))
    assert whole.shape == (dlrm.table_rows(cfg), 8)
    assert torch.equal(rows(150, 433), whole[150:433])
    pick = torch.tensor([3, 99, 100, 101, 1500, 2331])
    assert torch.equal(dlrm_whole.TableRows(cfg, 7, CPU).at(pick), whole[pick])
    assert abs(float(whole.std()) - dlrm.TABLE_SCALE) < 0.01
    # a rank's table: its ranges of the whole one, in the program's layout
    spec = bag_spec(cfg["feature_sizes"], cfg["numerical"], cfg["bag_sizes"])
    p = bag_sharding.BagPlacement(spec, 4, 2, cfg["bag_row_wise_rows"])
    local = bag_sharding.local_table(p, rows, 8, torch.float32, CPU)
    packed = torch.arange(dlrm.table_rows(cfg))
    at = bag_sharding.packed_to_local(p, packed, local.shape[0])
    held = at != local.shape[0] - 1
    assert torch.equal(local[at[held]], whole[held])
    assert bool((dlrm_whole.holder(cfg, packed, 4)[held] != -1).sum() > 0)
    assert torch.equal(held, (dlrm_whole.holder(cfg, packed, 4) == 2)
                       | (dlrm_whole.holder(cfg, packed, 4) == -1))


def test_the_hash_spreads_the_hot_ids_over_the_blocks():
    cfg, tr = _data("tiny_dlrm_whole"), _data("tiny_train_dlrm_rw4")
    xi, _, _ = dlrm_whole.sample_rows(cfg, tr, 20000, 5, 0, CPU)
    first = xi[:, 1]                              # the first id of the 905-row field's bag
    hot = np.bincount(first, minlength=905).argsort()[::-1][:8]
    assert len({int(i) // -(-905 // 4) for i in hot}) >= 3
    other = dlrm_whole.sample_rows(cfg, tr, 20000, 5, 1, CPU)[0]
    assert not np.array_equal(xi, other)          # each rank its own rows
    assert xi.min() >= 0 and (xi[:, 4:9] < 9).all() and (xi[:, 9:] < 1411).all()


def test_the_blocked_reference_is_the_straight_one():
    cfg = _data("tiny_dlrm_whole")
    w = {**dlrm_whole.dense(cfg, 3, CPU),
         ref.TABLE: dlrm_whole.TableRows(cfg, 3, CPU)(0, dlrm.table_rows(cfg))}
    xi, xv, y = dlrm_whole.sample_rows(cfg, _data("tiny_train_dlrm_rw4"), 3 * 200, 9, 0, CPU)
    batches = [{"rows": ref.packed_rows(cfg, torch.from_numpy(xi[i * 200:(i + 1) * 200])),
                "xv": torch.from_numpy(xv[i * 200:(i + 1) * 200]),
                "y": torch.from_numpy(y[i * 200:(i + 1) * 200])} for i in range(3)]
    want = ref.steps(w, cfg, batches)
    got = ref_blocks.steps(w, cfg, batches, block=64)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for k in want["grad"]:
        assert got["grad"][k] == pytest.approx(want["grad"][k], rel=1e-5), k
        assert got["change"][k] == pytest.approx(want["change"][k], rel=1e-5), k


def test_the_counts_at_the_configurations_shapes():
    # ids: 3 x 16,384 x (152 / 4 + 62) x 4 B; bags: 3 x 16,384 x (4.99 (+ 20)) x 512 B, 4.99 the
    # row-wise bags of a row that hold an id of a given block, 1 - (3/4)^k summed over k = 3, 7,
    # 3, 12, 100 and 27
    touched = dlrm_sharded_roofline.touched_blocks(CONFIG, 4)
    assert touched == pytest.approx(sum(1 - 0.75 ** k for k in (3, 7, 3, 12, 100, 27)))
    assert touched == pytest.approx(4.9907, abs=1e-4)
    assert dlrm_sharded_roofline.ids_bytes(CONFIG, 16384, 4) == 19_660_800
    assert dlrm_sharded_roofline.pool_bytes(CONFIG, 16384, 4) == pytest.approx(3 * 16384 * touched
                                                                               * 512)
    assert dlrm_sharded_roofline.pool_bytes(CONFIG, 16384, 4) == pytest.approx(125.594e6, rel=1e-5)
    assert dlrm_sharded_roofline.grad_bytes(CONFIG, 16384, 4) == pytest.approx(628.911e6, rel=1e-5)
    assert dlrm_sharded_roofline.exchange_least_seconds(CONFIG, 16384, 4) == pytest.approx(
        774.166e6 / 478.116e9, rel=1e-5)


def test_the_share_of_bags_that_touch_a_block_is_the_traffics():
    """Averaged over the blocks, the share of a row's row-wise bags that hold
    an id of a block is the count's, the zipf first id hashed over the rows."""
    cfg, tr = _data("tiny_dlrm_whole"), _data("tiny_train_dlrm_rw4")
    spec = bag_spec(cfg["feature_sizes"], cfg["numerical"], cfg["bag_sizes"])
    p = bag_sharding.BagPlacement(spec, 4, 0, cfg["bag_row_wise_rows"])
    xi = torch.cat([torch.from_numpy(dlrm_whole.sample_rows(cfg, tr, 4096, 13, r, CPU)[0])
                    for r in range(4)]).long()
    col = torch.tensor(spec.column_field)
    touched = 0.0
    for f in p.fields_of(True):
        block = xi[:, col == f] // p.blocks[f]
        touched += sum(float((block == j).any(1).double().mean()) for j in range(4)) / 4
    assert touched == pytest.approx(dlrm_sharded_roofline.touched_blocks(cfg, 4), rel=0.02)


def test_the_configuration_is_the_published_model_on_four_cards():
    assert CONFIG["feature_sizes"] == CONFIG["published_feature_sizes"] == ONE_CARD[
        "published_feature_sizes"]
    assert CONFIG["reduced"] == [] and set(ONE_CARD) <= set(CONFIG)
    entry = next(c for c in BENCH["configs"] if c["name"] == "dlrm_dcnv2_criteo1tb_whole")
    assert entry["reduced"] == [] and entry["source"] == CONFIG["source"] == ONE_CARD["source"]
    sizes = CONFIG["feature_sizes"][13:]
    assert sum(sizes) == CONFIG["rows_published"] == 204_184_588
    spec = bag_spec(CONFIG["feature_sizes"], 13, CONFIG["bag_sizes"])
    p = bag_sharding.BagPlacement(spec, 4, 0, CONFIG["bag_row_wise_rows"])
    assert p.rows - 1 == CONFIG["rows_held"] == 51_883_621 and p.whole_rows == 1_116_632
    assert sorted(n for n, rw in zip(sizes, p.row_wise) if rw) == [3_067_956] + [40_000_000] * 5
    assert 2 * 4 * 128 * CONFIG["rows_held"] == pytest.approx(53.13e9, rel=1e-3)
    assert CONFIG["parameters"] == sum(sizes) * 128 + 16_044_545
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    tr = json.loads((ROOT / "port_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert cell["chips"] == tr["ranks"] == CONFIG["deployment"]["cards"] == 4
    assert tr["batch"] * tr["ranks"] == CONFIG["global_batch"] == 65536
