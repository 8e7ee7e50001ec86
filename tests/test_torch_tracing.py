"""The port's tracing (``utils/profiling.py``, ``utils/cuda_graph.py``): spans
off and on, their parents, units and self time, the spans of an eager train
step and of a request on the CPU, a graph's traced variant and capture
counts, device spans read from a capture's events (with stand-ins for CUDA's
graph, streams and events), the clock of ``torch.profiler``'s trace and the
exporter. On the card (marked ``cuda``): the step's three phases against a
CUDA-event time of its replay, and no device spans from a graph captured with
tracing off. No JAX here, so the card's machine runs the card's tests:
``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import cuda_graph
from xsdeepfwfm_deprecated_torch.utils import profiling as P

SIZES = (1, 1, 1, 5, 9, 30)
CFG = ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=3, embedding_size=4,
                  h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                  use_fwlw=True)
STEP = ("step.forward", "step.backward", "step.optimizer")
REQUEST = ("request.copy_in", "request.launch", "request.wait", "request.copy_out")


@pytest.fixture(autouse=True)
def _tracing_left_off():
    P.spans()
    yield
    assert not P.enabled(), "a test left tracing on"
    P.spans()


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, SIZES[3:], size=(n, 3)).astype(np.int32),
            rng.normal(size=(n, 3)).astype(np.float32),
            (rng.random(n) < 0.4).astype(np.float32))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_tracing_off_records_nothing_and_named_scope_is_the_shared_null_context():
    assert not P.enabled()
    assert P.named_scope("a") is P.named_scope(P.SCOPE_DEEP, unit=True)
    with P.named_scope("a"):
        torch.ones(3).sum()
    assert P.spans() == []
    with P.tracing():
        assert P.enabled() and P.named_scope("a") is not P.named_scope("a")
        with P.tracing(False):
            with P.named_scope("off"):
                pass
        with P.named_scope("on"):
            pass
    assert [s.name for s in P.spans()] == ["on"]
    P.tracing(True)
    P.tracing(False)
    assert not P.enabled()


def test_spans_nest_and_share_the_unit_of_their_request():
    with P.tracing():
        with P.named_scope("before"):
            pass
        for _ in range(2):
            with P.named_scope("request", unit=True):
                with P.named_scope("child"):
                    with P.named_scope("grandchild"):
                        pass
                with P.named_scope("second child"):
                    pass
            with P.named_scope("after"):
                pass
        recorded = P.spans()
    assert P.spans() == []
    by = _by_name(recorded)
    assert [s.name for s in recorded][:4] == ["before", "grandchild", "child", "second child"]
    assert len({s.span_id for s in recorded}) == len(recorded)
    assert by["before"][0].parent_id == 0
    for i, req in enumerate(by["request"]):
        assert req.parent_id == 0 and req.unit_id == by["before"][0].unit_id + i + 1
        child, second = by["child"][i], by["second child"][i]
        assert child.parent_id == second.parent_id == req.span_id
        assert by["grandchild"][i].parent_id == child.span_id
        assert {child.unit_id, second.unit_id, by["grandchild"][i].unit_id} == {req.unit_id}
        assert by["after"][i].unit_id == req.unit_id and by["after"][i].parent_id == 0
        assert req.start_ns <= child.start_ns <= child.end_ns <= second.start_ns <= req.end_ns


def test_self_ms_subtracts_what_the_children_cover():
    S = P.Span
    recorded = [S("parent", 0, 10_000_000, 1, 0, 1),
                S("a", 1_000_000, 4_000_000, 2, 1, 1),
                S("b", 3_000_000, 5_000_000, 3, 1, 1),      # overlaps a: covered once
                S("c", 9_000_000, 12_000_000, 4, 1, 1),     # runs past the parent's end
                S("grandchild", 1_000_000, 2_000_000, 5, 2, 1),
                S("parent", 20_000_000, 21_000_000, 6, 0, 2)]
    assert P.self_ms(recorded, "parent") == pytest.approx([10 - 4 - 1, 1.0])
    assert P.self_ms(recorded, "a") == pytest.approx([2.0])
    assert P.self_ms(recorded, "none") == []


def test_an_eager_train_step_on_the_cpu_nests_its_phases_in_train_step():
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    tc = TrainConfig(batch_size=8, learning_rate=1e-2)
    opt = trainer.make_optimizer(tc)
    state = opt.init(params)
    step = trainer.make_train_step(CFG, tc, opt)
    refresh = trainer.PruneRefresh(dict(emb_r=0.5, emb_corr=1.0, prune_fm=True,
                                        prune_deep=True, prune_r=True))
    xi, xv, y = _rows(24)
    feed = batching.prefetch_to_device(batching.iter_batches(xi, xv, y, 8), torch.device("cpu"))
    with P.tracing():
        for batch in feed:
            step(params, state, batch)
        refresh(params, 0.3)
        recorded = P.spans()
    by = _by_name(recorded)
    steps = by["train.step"]
    assert len(steps) == 3 and len(by["feed.stage"]) == 3 and len(by["train.refresh"]) == 1
    assert len({s.unit_id for s in steps}) == 3
    for st in steps:
        phases = [next(s for s in by[name] if s.parent_id == st.span_id) for name in STEP]
        assert all(p.unit_id == st.unit_id for p in phases)
        assert st.start_ns <= phases[0].start_ns and phases[-1].end_ns <= st.end_ns
        assert phases[0].end_ns <= phases[1].start_ns and phases[1].end_ns <= phases[2].start_ns
        fwd = phases[0].span_id
        assert {s.name for s in recorded if s.parent_id == fwd} == {
            P.SCOPE_FM, P.SCOPE_FWLW, P.SCOPE_OUTER_FWFM, P.SCOPE_DEEP}
    assert by["train.refresh"][0].unit_id == steps[-1].unit_id     # the refresh after a step
    assert all(s.parent_id == 0 for s in by["feed.stage"] + by["train.refresh"])
    assert not any(s.name.startswith(P.DEVICE) for s in recorded)


def test_a_request_on_the_cpu_nests_its_copies_launch_and_wait_in_request():
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    pred = Predictor(params, CFG, device="cpu")
    xi, xv, _ = _rows(16)
    untraced = pred.logits(xi, xv)
    with P.tracing():
        traced = [pred.logits(xi[:8], xv[:8]), pred.logits(xi, xv)]
        recorded = P.spans()
    assert np.array_equal(traced[1], untraced) and traced[0].shape == (8,)
    by = _by_name(recorded)
    assert len(by["request"]) == 2 and by["request"][0].unit_id != by["request"][1].unit_id
    for req in by["request"]:
        parts = [next(s for s in by[name] if s.parent_id == req.span_id) for name in REQUEST]
        assert [p.unit_id for p in parts] == [req.unit_id] * 4
        assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
        assert req.start_ns <= parts[0].start_ns and parts[-1].end_ns <= req.end_ns
        launch = parts[1].span_id
        assert P.SCOPE_DEEP in {s.name for s in recorded if s.parent_id == launch}
    assert P.self_ms(recorded, "request.launch")[0] < (
        (by["request.launch"][0].end_ns - by["request.launch"][0].start_ns) * 1e-6)


class _FakeStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _FakeGraph:
    """A CUDA graph stand-in: capture runs the function once, replay runs
    what the test puts in ``fn``."""

    def __init__(self):
        self.fn = lambda: None

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.fn()


class _FakeEvent:
    """A timing event stand-in on a clock that moves 1 ms a record."""
    clock = [0.0]

    def __init__(self, enable_timing=False, blocking=False, interprocess=False, external=False):
        self.external, self.at, self.done = external, None, True

    def record(self, stream=None):
        self.at = _FakeEvent.clock[0]
        _FakeEvent.clock[0] += 1.0

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.at - self.at


def _cuda_on_the_cpu(monkeypatch):
    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(P._T, "anchors", {})


def test_tracing_on_captures_a_second_variant_and_off_goes_back_to_the_first(monkeypatch):
    _cuda_on_the_cpu(monkeypatch)
    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    compiled = cuda_graph.Compiled(lambda x: x + 1, "g", device=torch.device("cpu"))
    before = P.counters()["captures"].get("g", 0)

    def get():      # the graph whose replay load returns
        return compiled.load((), {"x": torch.ones(2)}).__self__

    first = get()
    assert get() is first and len(compiled) == 1
    with P.tracing():
        traced = get()
        assert traced is not first and get() is traced and len(compiled) == 2
    assert get() is first and len(compiled) == 2
    with P.tracing():
        assert get() is traced
    assert P.counters()["captures"]["g"] == before + 2
    assert first.device_spans is None and traced.device_spans is None   # no span inside
    name, at = cuda_graph.CAPTURES[-1]
    assert name == "g" and at <= time.perf_counter_ns()


def test_counters_read_the_launches_and_a_log():
    from xsdeepfwfm_deprecated_torch.ops.cuda.bag_adagrad import bag_adagrad
    from xsdeepfwfm_deprecated_torch.ops.cuda.cin import cin
    from xsdeepfwfm_deprecated_torch.ops.cuda.fused_adam import fused_adam
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.ops.cuda.prune_search import prune_search
    traffic = [("all-reduce", "world", 4, 8)] * 3
    int8_mlp.launches = 5
    out = P.counters(traffic=cuda_graph.Log(traffic))
    assert out["launches"]["int8_mlp"] == 5 and out["extra"] == {"traffic": 3}
    assert sorted(out["launches"]) == ["bag_adagrad", "cin", "fused_adam", "int8_mlp",
                                       "prune_search"]
    assert out["launches"]["bag_adagrad"] == bag_adagrad.launches
    assert out["launches"]["cin"] == cin.launches
    assert out["launches"]["fused_adam"] == fused_adam.launches
    assert out["launches"]["prune_search"] == prune_search.launches
    assert "extra" not in P.counters() and isinstance(P.counters()["captures"], dict)


def test_a_traced_capture_reads_each_replays_device_spans(monkeypatch):
    """Spans opened inside a capture become event pairs in the graph; a
    replay whose last event has completed is read at the next replay, one
    still running is waited for (``trace.read``) one replay in READ_EVERY and
    otherwise skipped; draining the spans reads the last replay."""
    _cuda_on_the_cpu(monkeypatch)

    def fn(x):
        with P.named_scope("outer"):
            with P.named_scope("inner"):
                y = x * 2
            with P.named_scope("second"):
                return y + 1

    with P.tracing():
        with P.named_scope("set-up"):
            g = cuda_graph.Graphed(fn, (torch.ones(2),), device=torch.device("cpu"),
                                   name="traced")
        set_up = P.spans()      # the warm-up ran eagerly; the capture records no host span
        assert sorted(s.name for s in set_up) == ["inner", "outer", "second", "set-up"]
        scopes = g.device_spans
        assert [s[0] for s in scopes.scopes] == ["outer", "inner", "second"]
        assert all(e.external for _, a, b, _ in scopes.scopes for e in (a, b))
        running = [False]

        def replay():
            for e in (e for _, a, b, _ in scopes.scopes for e in (a, b)):
                e.done = not running[0]
        g.graph.fn = replay
        units = []
        for i in range(2 * P.READ_EVERY + 2):
            running[0] = i >= 2         # the first two complete, the rest still run
            with P.named_scope("step", unit=True):
                g.replay()
            units.append(P._T.unit)
        recorded = P.spans()
    by = _by_name(recorded)
    # replays 1 and 2 completed; 17 and 33 were waited for; 34, the last, is read when drained
    read_units = sorted({s.unit_id for s in by[P.DEVICE + "outer"]})
    assert read_units == [units[0], units[1], units[16], units[32], units[33]]
    assert len(by["trace.read"]) == 5
    for outer in by[P.DEVICE + "outer"]:
        inner = next(s for s in by[P.DEVICE + "inner"] if s.parent_id == outer.span_id)
        second = next(s for s in by[P.DEVICE + "second"] if s.parent_id == outer.span_id)
        assert outer.parent_id == 0 and inner.unit_id == second.unit_id == outer.unit_id
        assert (outer.start_ns < inner.start_ns < inner.end_ns < second.start_ns
                < second.end_ns < outer.end_ns)
        assert inner.end_ns - inner.start_ns == 1_000_000        # one fake record apart
    assert not P._T.unread


def test_a_span_converts_to_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    with P.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with P.named_scope("mine"):
                with record_function("theirs"):
                    torch.ones(4).sum()
        mine = P.spans()[0]
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    theirs = next(e for e in doc["traceEvents"] if e.get("name") == "theirs")
    at = float(theirs["ts"]) * 1e3 + doc["baseTimeNanoseconds"]
    assert abs(at - P.trace_clock_ns(mine.start_ns)) < 1e6
    assert P.trace_clock_ns(mine.start_ns) <= at + 1e5


def test_trace_writes_the_program_spans_into_trace_json(tmp_path):
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    pred = Predictor(params, CFG, device="cpu")
    xi, xv, _ = _rows(8)
    with P.trace(str(tmp_path)):
        pred.logits(xi, xv)
    assert not P.enabled()
    doc = json.loads((tmp_path / P.TRACE_FILE).read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
            and "span_id" in e.get("args", {})]
    names = {e["name"] for e in ours}
    assert {"request", *REQUEST, P.SCOPE_DEEP} <= names
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    req = next(e for e in ours if e["name"] == "request")
    inside = [e for e in ops if req["ts"] <= e["ts"] <= req["ts"] + req["dur"]]
    assert inside, "the profiler's operations of the request lie inside its span"


# ---- on the card

def _card_step():
    """A step of the flagship's shape (39 fields, E=10, 400x400x400, B=2048)
    on a smaller table."""
    sizes = (1,) * 13 + (10_000,) * 26
    cfg = ModelConfig(field_size=39, feature_sizes=sizes, numerical=13, embedding_size=10,
                      h_depth=3, deep_nodes=400, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True, dropout_deep=0.5)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tc = TrainConfig(batch_size=2048, learning_rate=1e-3, weight_decay=3e-7)
    opt = trainer.make_optimizer(tc)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {"xi": torch.from_numpy(rng.integers(0, 10_000, (2048, 26)).astype(np.int32)),
             "xv": torch.from_numpy(rng.normal(size=(2048, 13)).astype(np.float32)),
             "y": torch.from_numpy((rng.random(2048) < 0.25).astype(np.float32)),
             "mask": torch.ones(2048)}
    batch = {k: v.cuda() for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    return trainer.make_train_step(cfg, tc, opt), params, state, batch, gen


@pytest.mark.cuda
def test_the_step_phases_sum_to_the_replays_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    step, params, state, batch, gen = _card_step()
    with P.tracing():
        step(params, state, batch, gen)             # the traced variant's capture
        torch.cuda.synchronize()
        P.spans()
        times = []
        for _ in range(2 * P.READ_EVERY):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10_000_000)     # the card busy while the host issues the step
            a.record()
            step(params, state, batch, gen)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        recorded = P.spans()
    by = _by_name(recorded)
    assert len(by[P.DEVICE + "step.forward"]) == 2 * P.READ_EVERY     # each replay completed
    phases = sum(np.mean([(s.end_ns - s.start_ns) * 1e-6 for s in by[P.DEVICE + name]])
                 for name in STEP)
    assert phases == pytest.approx(float(np.mean(times)), rel=0.1)
    deep = by[P.DEVICE + P.SCOPE_DEEP]
    assert {s.parent_id for s in deep} <= {s.span_id for s in by[P.DEVICE + "step.forward"]}


@pytest.mark.cuda
def test_a_graph_captured_with_tracing_off_yields_no_device_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    step, params, state, batch, gen = _card_step()
    step(params, state, batch, gen)                 # captured with tracing off
    graph = next(iter(step._graphs._held.values()))[1]
    assert graph.device_spans is None
    with P.tracing():
        graph.load(batch["xi"], batch["xv"], batch["y"], batch["mask"])
        graph.replay()
        torch.cuda.synchronize()
        recorded = P.spans()
    assert recorded == []
