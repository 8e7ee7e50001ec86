"""The harness: BENCHMARK.json within the contract's form, everything found by its
name, no run without a card, and nothing of JAX loaded."""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "port_bench"


def test_benchmark_json_names_units_and_files():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert (PB / "end_to_end" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    for m in BENCH["per_layer"]:
        assert run.reader_path(m["name"], True).exists()
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "limits" / f"{w['name']}.json").exists()
        assert len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in run.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(BENCH, w["name"], True)


def test_a_suffixed_metric_is_read_by_its_own_file_or_its_stem():
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    assert run.reader_path("mfu_pct.train", True).name == "mfu_pct.train.py"
    assert run.reader_path("mfu_pct.latency", True).name == "mfu_pct.py"
    assert run.reader_path("device_idle_pct.anything", True).name == "device_idle_pct.py"
    assert run.reader_path("setup_s", False) == PB / "end_to_end" / "setup_s.py"


JUDGED = [({"a": 1.0, "b": 2.0}, True),
          ({"a": 1.0}, False),                          # a check that was not made
          ({"a": 1.0, "b": 2.0, "c": 0.0}, False),      # a number with no limit
          ({}, False),
          ({"a": 1.0, "b": 2.5}, False),
          ({"a": float("nan"), "b": 2.0}, False)]


@pytest.mark.parametrize("checks, correct", JUDGED, ids=["within", "missing", "unlimited",
                                                         "none", "over", "nan"])
def test_correct_needs_every_limit_compared_and_within(checks, correct):
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    assert run.judge(checks, {"a": 1.0, "b": 2.0}) is correct


def test_a_loop_that_drops_a_check_reads_not_correct():
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench import run
    from port_bench.harness import Context, Record
    limits = json.loads((PB / "limits" / "criteo_train_prune.json").read_text())
    ctx = Context(cell="criteo_train_prune", config={}, traffic={}, seed=1, seconds=1.0,
                  trace=False, device=torch.device("cpu"), limits=limits, started=0.0)
    rec = Record(setup_s=1.0, window_s=1.0, examples=10, attempted=1,
                 checks={k: 0.0 for k in limits})
    assert run.result_line(BENCH, rec, ctx)["correct"]
    del rec.checks["refresh_gap"]
    line = run.result_line(BENCH, rec, ctx)
    assert not line["correct"] and set(line["checks"]) == set(limits) - {"refresh_gap"}


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


CARD_ONLY = [_ev("cuda_runtime", "cudaGraphLaunch", 100.0, 10.0),
             _ev("kernel", "gemm", 105.0, 40.0),
             _ev("kernel", "relu", 150.0, 10.0),
             _ev("cuda_runtime", "cudaStreamSynchronize", 120.0, 80.0),
             _ev("gpu_memcpy", "Memcpy DtoH", 190.0, 10.0)]


@pytest.mark.parametrize("events, busy, window", [
    (CARD_ONLY, 60e-6, 100e-6),
    (CARD_ONLY + [_ev("user_annotation", "port_bench.window", 50.0, 200.0)], 60e-6, 200e-6)],
    ids=["card_only", "with_window_span"])
def test_the_trace_reduces_to_busy_time_and_window(events, busy, window):
    sys.path.insert(0, str(ROOT))
    from port_bench import harness
    b, w, breakdown = harness.reduce_trace(events)
    assert b == pytest.approx(busy) and w == pytest.approx(window)
    assert breakdown["device_ops"][0] == ["gemm", pytest.approx(40e-6)]
    gaps = dict(breakdown["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)


def test_the_idle_share_is_read_against_the_windows_own_time():
    """A stretch the tracer slowed to twice the window's time a request
    still reads the window's idle share."""
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    from port_bench.harness import Record
    rec = Record(window_s=10.0, attempted=10_000, busy_s=0.03, traced_s=0.1, traced_units=50)
    assert run.reader("device_idle_pct.latency", True)(rec, None) == pytest.approx(40.0)


def _run_py(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload", "criteo_train_prune",
                           "--seed", "3000000019", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    res = _run_py(ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copytree(PB, tmp_path / "port_bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run_py(tmp_path, env=env)
    assert res.returncode != 0
    assert "{" not in res.stdout


NEW_READER = '''"""Steps the window ran."""


def read(rec, ctx):
    return rec.attempted
'''


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added only
    as files and entries run through an unedited run.py (on the CPU here)."""
    shutil.copytree(PB, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "port_bench"
    shutil.copy(HERE / "data" / "tiny_avazu.json", pb / "configs" / "tiny_new.json")
    (pb / "traffic" / "tiny_new_mix.json").write_text(
        (HERE / "data" / "tiny_train_prune.json").read_text().replace('"prune": 1', '"prune": 0'))
    (pb / "layer_metrics" / "steps_in_window.py").write_text(NEW_READER)
    (pb / "limits" / "tiny_new_cell.json").write_text(
        (PB / "limits" / "avazu_train_dense.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny_new", "source": "test", "reduced": [],
                             "file": "port_bench/configs/tiny_new.json", "why": "test"})
    bench["workloads"].append({"name": "tiny_new_cell", "config": "tiny_new",
                               "traffic": "tiny_new_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training step",
                               "moves": "train_examples_per_s", "workloads": ["tiny_new_cell"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_examples_per_s")["workloads"].append("tiny_new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert (pb / "run.py").read_bytes() == (PB / "run.py").read_bytes()
    code = ("import json, sys, time, torch\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "from port_bench import run\n"
            "bench = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
            "lines = []\n"
            "for trace in (False, True):\n"
            "    rec, ctx = run.run_spec(run.cell_spec(bench, 'tiny_new_cell'), 'tiny_new_cell',\n"
            "                            2**31 + 77, 0.3, trace, torch.device('cpu'),\n"
            "                            time.perf_counter())\n"
            "    lines.append(run.result_line(bench, rec, ctx))\n"
            "print(json.dumps(lines))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert traced["metrics"]["steps_in_window"]["value"] == traced["attempted"] > 0
    assert "feed_wait_ms" not in traced["metrics"]      # listed for other cells only
    assert plain["correct"] and traced["correct"], (plain["checks"], traced["checks"])


def test_importing_the_harness_loads_no_jax_and_the_reference_no_program():
    files = sorted(str(p) for p in list((PB / "end_to_end").glob("*.py"))
                   + list((PB / "layer_metrics").glob("*.py")))
    code = ("import importlib, importlib.util, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "for m in ['port_bench.run', 'port_bench.harness', 'port_bench.generator',\n"
            "          'port_bench.compare', 'port_bench.roofline', 'port_bench.weights',\n"
            "          'port_bench.calibrate', 'port_bench.faults', 'port_bench.program',\n"
            "          'port_bench.loops.train_per_batch', 'port_bench.loops.serve_closed_loop',\n"
            "          'port_bench.reference.model', 'port_bench.reference.train']:\n"
            "    importlib.import_module(m)\n"
            f"for i, f in enumerate({files!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'reader{i}', f)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "xsdeepfwfm_deprecated_tpu"}
    assert "xsdeepfwfm_deprecated_torch" in loaded
    code = (f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "import port_bench.reference.model, port_bench.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "xsdeepfwfm_deprecated_tpu", "xsdeepfwfm_deprecated_torch"}


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_sources_import_no_jax(path):
    banned = {"jax", "jaxlib", "flax", "xsdeepfwfm_deprecated_tpu"}
    if "reference" in path.parts:
        banned.add("xsdeepfwfm_deprecated_torch")
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] in banned for n in names), (path, names)
