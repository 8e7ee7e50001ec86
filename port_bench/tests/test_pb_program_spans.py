"""The program's spans in a traced run (``program_spans.py``): idle gaps named
by the program's host spans on the trace's clock, the graph launches inside
their spans, each span metric's reader on a record whose spans are given,
and nothing read where the program has no spans. Then a traced run of a tiny
training and serving cell on the CPU, which reads the host spans."""

import json
import pathlib
import sys
import time

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

from port_bench import program_spans, run  # noqa: E402
from port_bench.harness import Record  # noqa: E402
from xsdeepfwfm_deprecated_torch.utils.profiling import Span  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BASE = 1_000_000_000_000        # the trace's baseTimeNanoseconds
OFFSET = 5_000_000              # Unix ns less perf_counter ns


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, start_us, end_us, span_id, parent=0, unit=1):
    """A span whose times, put on the trace's clock, read ``start_us`` and
    ``end_us`` after the trace's base."""
    to_perf = lambda us: int(us * 1e3) + BASE - OFFSET     # noqa: E731
    return Span(name, to_perf(start_us), to_perf(end_us), span_id, parent, unit)


# a request: copy in (the card idle), launch, the kernels, the copy out; then the loop
EVENTS = [_ev("cuda_runtime", "cudaMemcpyAsync", 100.0, 30.0),
          _ev("gpu_memcpy", "Memcpy HtoD", 130.0, 6.0),
          _ev("cuda_runtime", "cudaGraphLaunch", 140.0, 20.0),
          _ev("kernel", "gemm", 165.0, 40.0),
          _ev("gpu_memcpy", "Memcpy DtoH", 210.0, 5.0),
          _ev("cuda_runtime", "cudaGraphLaunch", 300.0, 10.0),
          _ev("kernel", "gemm", 320.0, 10.0)]
SPANS = [_span("request", 95.0, 240.0, 1),
         _span("request.copy_in", 96.0, 135.0, 2, 1),
         _span("request.launch", 136.0, 162.0, 3, 1),
         _span("trace.read", 137.0, 139.0, 4, 3),
         _span("request.copy_out", 216.0, 239.0, 5, 1),
         _span("device:Deep - Component", 170.0, 200.0, 6, 0),
         _span("request", 290.0, 335.0, 7, unit=2),
         _span("request.launch", 295.0, 312.0, 8, 7, unit=2)]


def test_idle_gaps_are_named_by_the_innermost_program_span_on_the_trace_clock():
    """The window runs from 100 to 330 us, busy 130-136, 165-205, 210-215 and
    320-330; each gap takes the shortest host span over its midpoint."""
    gaps, named = program_spans.gaps_by_span(EVENTS, SPANS, OFFSET, BASE)
    assert dict(gaps) == {"request.copy_in": pytest.approx(30e-6),      # 100-130
                          "request.launch": pytest.approx(29e-6),       # 136-165
                          "request": pytest.approx(5e-6),               # 205-210
                          program_spans.NO_SPAN: pytest.approx(105e-6)}  # 215-320
    assert named == pytest.approx(1 - 105 / 169)


def test_a_wrong_clock_offset_names_no_span():
    gaps, named = program_spans.gaps_by_span(EVENTS, SPANS, OFFSET + 2_000_000_000, BASE)
    assert [k for k, _ in gaps] == [program_spans.NO_SPAN] and named == 0.0


def test_graph_launches_lie_in_the_spans_that_launch():
    assert program_spans.launches_in_spans(EVENTS, SPANS, OFFSET, BASE) == 1.0
    moved = [_span("request.launch", 0.0, 10.0, 3)]
    assert program_spans.launches_in_spans(EVENTS, moved, OFFSET, BASE) == 0.0
    no_launch = [e for e in EVENTS if e["name"] != "cudaGraphLaunch"]
    assert program_spans.launches_in_spans(no_launch, SPANS, OFFSET, BASE) is None


STEP_SPANS = [_span("feed.stage", 0.0, 40.0, 1, unit=0),
              _span("train.step", 50.0, 100.0, 2, unit=1),
              _span("trace.read", 60.0, 80.0, 3, 2, unit=1),
              _span("device:step.forward", 100.0, 400.0, 4, unit=1),
              _span("device:Deep - Component", 150.0, 250.0, 5, 4, unit=1),
              _span("device:step.backward", 400.0, 1000.0, 6, unit=1),
              _span("device:step.optimizer", 1000.0, 1500.0, 7, unit=1),
              _span("feed.wait", 100.0, 300.0, 8, unit=1),
              _span("feed.stage", 300.0, 320.0, 9, unit=1),
              _span("train.step", 320.0, 380.0, 10, unit=2),
              _span("train.refresh", 380.0, 480.0, 11, unit=2)]

READ = [("step_forward_device_ms", STEP_SPANS, 0.3),
        ("step_backward_device_ms", STEP_SPANS, 0.6),
        ("step_optimizer_device_ms", STEP_SPANS, 0.5),
        ("train_host_ms", STEP_SPANS, (40 + 20 + (50 - 20) + 60 + 100) * 1e-3 / 2),
        ("request_copy_in_ms.tput", SPANS, 0.039),
        ("request_launch_ms.latency", SPANS, ((26 - 2) + 17) * 1e-3 / 2),
        ("request_copy_out_ms.tput", SPANS, 0.023),
        ("tower_device_ms.latency", SPANS, 0.03)]


@pytest.mark.parametrize("metric, spans, ms", READ, ids=[r[0] for r in READ])
def test_each_span_metric_reads_its_spans_and_nothing_without_them(metric, spans, ms):
    rec = Record()
    rec.program_spans = spans
    assert run.reader(metric, True)(rec, None) == pytest.approx(ms)
    rec.program_spans = None                  # a program without tracing
    assert run.reader(metric, True)(rec, None) is None
    rec.program_spans = [s for s in spans if s.name == "nothing"]
    assert run.reader(metric, True)(rec, None) is None


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    rec = Record()
    assert run.reader("train_host_ms", True)(rec, None) is None
    assert rec.program_spans is None and rec.info == {}


@pytest.mark.parametrize("cell", ["criteo_train_prune", "avazu_serve_fp32_b1"])
def test_a_traced_tiny_run_on_the_cpu_reads_the_host_spans(cell):
    import test_pb_faults as faults_tests
    rec, ctx = run.run_spec(faults_tests._spec(cell), cell, 2 ** 31 + 5, 0.3, True,
                            torch.device("cpu"), time.perf_counter())
    line = run.result_line(BENCH, rec, ctx)
    assert line["correct"], line["checks"]
    host = (["train_host_ms"] if "train" in cell else
            ["request_copy_in_ms.latency", "request_launch_ms.latency",
             "request_copy_out_ms.latency"])
    assert all(line["metrics"][m]["value"] > 0 for m in host), line["metrics"]
    assert not any(m.startswith(("step_", "tower_")) for m in line["metrics"])   # no card
    assert rec.info["graph_captures_in_window"] == 0
    units = 100 if "train" in cell else 500
    unit = "train.step" if "train" in cell else "request"
    for part in ("program_spans", "profiled_spans"):     # without the profiler and under it
        assert rec.info[part][unit][0] == units
    assert sum(s.name == unit for s in rec.program_spans) == units
    assert set(rec.info["runtime_calls_ms"]) == set()            # no card, no runtime calls
