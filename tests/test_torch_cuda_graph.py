"""The CUDA-graph dispatch (``utils/cuda_graph.py``): on the CPU, with
stand-ins for CUDA's graph, capture and streams, the launch counts and a
mesh's ``traffic`` through a replay, a sharded step's generator, a failed
capture, what ``Compiled`` decides (eager or replay, when to capture) and the
kernels' launch counters; on the card (marked ``cuda``), a graphed ``Predictor``, a graphed
multi-step, a padded pruning group, the hash-MLP baseline's fit and
``calibrate`` against their eager forms. No JAX here, so the card's
machine runs the card's test: ``python -m pytest --noconftest
tests/test_torch_cuda_graph.py -m cuda``.
"""

import contextlib
import gc
import importlib
import weakref

import numpy as np
import pytest
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.ops.cuda import _build
from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import cuda_graph
from xsdeepfwfm_deprecated_torch.utils import profiling

SIZES = (1, 1, 1, 5, 9, 30)


class _FakeStream:
    def wait_stream(self, other):
        pass


def _streams_on_the_cpu(monkeypatch, capture):
    """CUDA's graph, capture and streams replaced by stand-ins for the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())


class _FakeGraph:
    """A CUDA graph stand-in for the CPU: capture runs the function once,
    replay runs it again, as the recorded kernels would."""

    def __init__(self):
        self.fn = None

    def register_generator_state(self, gen):
        self.generators = getattr(self, "generators", []) + [gen]

    def replay(self):
        self.fn()


def test_graph_replay_counts_the_captured_launches(monkeypatch):
    """A function that launches the fused tower twice: its warm-up and its
    capture leave ``int8_mlp.launches`` as they found it, and each replay
    adds the two launches that the capture recorded (CUDA's capture and
    streams are replaced by stand-ins that run on the CPU)."""
    graphs = []

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        graphs.append(graph)
        yield

    _streams_on_the_cpu(monkeypatch, capture)
    out = torch.zeros(3)

    def two_towers(x):
        for _ in range(2):
            int8_mlp.launches += 1
            out.add_(x)
        return out

    monkeypatch.setattr(int8_mlp, "launches", 7)     # the count is the process's: restored after
    gen = torch.Generator()
    g = cuda_graph.Graphed(two_towers, (torch.ones(3),), device=torch.device("cpu"),
                           name="two towers", generators=(gen,))
    graphs[0].fn = lambda: out.add_(2 * g.inputs[0])   # the recorded kernels, not the wrapper
    assert int8_mlp.launches == 7 and g.captured["int8_mlp"] == 2
    assert all(n == 0 for name, n in g.captured.items() if name != "int8_mlp")
    assert graphs[0].generators == [gen]
    g.load(torch.full((3,), 2.0))
    res = g.replay()
    assert int8_mlp.launches == 9 and res is out
    g.replay()
    assert int8_mlp.launches == 11


def test_graph_capture_failure_names_the_function(monkeypatch):
    """A capture that fails raises, naming the function, and leaves the
    launch counts as they were."""

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is capturing")
        yield

    _streams_on_the_cpu(monkeypatch, capture)
    monkeypatch.setattr(int8_mlp, "launches", 3)

    def tower(x):
        int8_mlp.launches += 1
        return x

    with pytest.raises(RuntimeError, match="the tower cannot be captured"):
        cuda_graph.Graphed(tower, (torch.ones(2),), device=torch.device("cpu"), name="the tower")
    assert int8_mlp.launches == 3


def test_graph_replay_appends_the_captured_traffic(monkeypatch):
    """A function that records two collectives in a mesh's ``traffic``: the
    warm-up and the capture leave the list as they found it, the barrier runs
    between them, the capture is ``thread_local`` (NCCL's watchdog thread
    queries events meanwhile), and each replay appends the two captured
    entries; a capture that fails raises, naming the function, and leaves the
    list as it was."""
    modes, calls = [], []

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        calls.append("capture")
        graph.fn = lambda: None          # the recorded kernels: nothing to run here
        yield

    _streams_on_the_cpu(monkeypatch, capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    traffic = [("all-reduce", "world", 4, 8)]

    def step(x):
        traffic.append(("all-to-all", "world", 4, 64))
        traffic.append(("all-reduce", "data", 2, 16))
        return x

    g = cuda_graph.Graphed(step, (torch.ones(2),), device=torch.device("cpu"), name="a step",
                           counters=(cuda_graph.Log(traffic),),
                           barrier=lambda: calls.append("barrier"))
    assert calls == ["barrier", "capture"] and modes == ["thread_local"]
    assert traffic == [("all-reduce", "world", 4, 8)]
    assert g.captured["traffic"] == [("all-to-all", "world", 4, 64), ("all-reduce", "data", 2, 16)]
    assert all(n == 0 for name, n in g.captured.items() if name in cuda_graph.KERNELS)
    g.load(torch.ones(2))
    g.replay()
    g.replay()
    assert traffic == [("all-reduce", "world", 4, 8)] + 2 * [("all-to-all", "world", 4, 64),
                                                             ("all-reduce", "data", 2, 16)]

    @contextlib.contextmanager
    def failing(graph, stream=None, capture_error_mode="global"):
        traffic.append(("all-gather", "model", 2, 32))
        raise RuntimeError("operation not permitted when stream is capturing")
        yield

    monkeypatch.setattr(torch.cuda, "graph", failing)
    before = list(traffic)
    with pytest.raises(RuntimeError, match="a sharded step cannot be captured"):
        cuda_graph.Graphed(step, (torch.ones(2),), device=torch.device("cpu"),
                           name="a sharded step", counters=(cuda_graph.Log(traffic),))
    assert traffic == before


def test_batch_shard_generator_is_registered_and_not_advanced(monkeypatch):
    """A sharded step draws through ``ops.mlp.BatchShard``: a ``Compiled``
    step with the shard in its state registers the generator inside it, and
    warms up on ``BatchShard.clone`` (a shard around a clone of the
    generator), which draws the numbers the capture draws and leaves the
    step's generator where it was."""
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard, dropout
    graphs = []

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        graphs.append(graph)
        graph.fn = lambda: None
        yield

    _streams_on_the_cpu(monkeypatch, capture)
    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    gen = torch.Generator().manual_seed(3)
    shard = BatchShard(gen, 8, 4)
    state = gen.get_state()
    seen = []

    def step(w, shard, x):
        seen.append((shard, shard.generator.get_state(), dropout(shard, x, 0.5, True)))
        return w + 1

    cuda_graph.Compiled(step, "a sharded step", writes_state=True)(
        (torch.zeros(2), shard), {"x": torch.ones(4, 3)})
    (warm, warm_state, warm_draws), (real, real_state, real_draws) = seen
    assert isinstance(warm, BatchShard) and warm.generator is not gen and real is shard
    assert (warm.batch, warm.start) == (8, 4)
    assert torch.equal(warm_state, state) and torch.equal(real_state, state)
    assert graphs[0].generators == [gen]
    torch.testing.assert_close(warm_draws, real_draws, rtol=0, atol=0)


# (name, the card stood in for, collectives capturable, the calls, (captures, graphs held,
# eager runs)): "plain" a call on the state, "replaced" on a new parameter tree, "traced"
# with tracing on, "anomaly" in autograd's anomaly mode
DECISIONS = [
    ("a CPU device runs eagerly", False, True, ["plain", "plain"], (0, 0, 2)),
    ("a gloo mesh runs eagerly", True, False, ["plain", "plain"], (0, 0, 2)),
    ("the card captures once, then replays", True, True, ["plain", "plain", "plain"], (1, 1, 0)),
    ("a replaced state captures again", True, True, ["plain", "replaced", "plain"], (3, 1, 0)),
    ("tracing captures a traced variant", True, True, ["plain", "traced", "plain", "traced"],
     (2, 2, 0)),
    ("a stateful call raises in anomaly mode", True, True, ["plain", "anomaly"], (1, 1, 0)),
]


@pytest.mark.parametrize("case, card, capturable, calls, want", DECISIONS,
                         ids=[d[0] for d in DECISIONS])
def test_compiled_decides_eager_or_replay_and_when_to_capture(case, card, capturable, calls,
                                                              want, monkeypatch):
    """What ``Compiled`` decides on each call of a step that writes its state,
    with CUDA's graph, capture, streams and events stood in for on the CPU:
    eager or replay, when it captures, and that each capture's warm-up ran on
    clones of the state and of the generator and the capture on the state."""
    from test_torch_tracing import _cuda_on_the_cpu
    _cuda_on_the_cpu(monkeypatch)
    if card:
        monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    seen = []

    def step(w, gen, x):
        seen.append((w, gen))
        return w + x

    w, other, gen = torch.zeros(2), torch.zeros(2), torch.Generator().manual_seed(0)
    compiled = cuda_graph.Compiled(step, "a step", writes_state=True, capturable=capturable)
    before = len(cuda_graph.CAPTURES)
    for call in calls:
        args = ((other if call == "replaced" else w, gen), {"x": torch.ones(2)})
        if call == "anomaly":
            with torch.autograd.set_detect_anomaly(True), \
                    pytest.raises(RuntimeError, match="anomaly detection"):
                compiled(*args)
            continue
        with profiling.tracing() if call == "traced" else contextlib.nullcontext():
            out = compiled(*args)
        assert torch.equal(out, torch.ones(2))
    captures, held, eager = want
    assert len(cuda_graph.CAPTURES) - before == captures and len(compiled) == held
    assert len(seen) == 2 * captures + eager
    for (warm_w, warm_gen), (cap_w, cap_gen) in zip(seen[0:2 * captures:2],
                                                     seen[1:2 * captures:2]):
        assert warm_w is not cap_w and warm_gen is not gen and cap_gen is gen
        assert cap_w is w or cap_w is other
    assert all(s == (w, gen) for s in seen[2 * captures:])


def test_the_warm_up_and_the_capture_see_tensors_of_their_own(monkeypatch):
    """The warm-up and the capture each call the function on views of their own over the static
    buffers: a function that caches by a tensor's identity, as the all-to-all lookup's one index
    exchange a forward does (``parallel/embedding_sharding._make_lookup``), recomputes inside
    the capture, so the graph holds the computation and not the warm-up's result (the card stood
    in for on the CPU)."""
    from test_torch_tracing import _cuda_on_the_cpu
    _cuda_on_the_cpu(monkeypatch)
    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    cache, seen = {"x": None}, []

    def step(w, x):
        seen.append(x)
        if cache["x"] is not x:
            cache["x"], cache["y"] = x, x * 2
        return w + cache["y"]

    compiled = cuda_graph.Compiled(step, "a cached step", writes_state=True)
    compiled((torch.zeros(2),), {"x": torch.ones(2)})
    warm, captured = seen
    assert warm is not captured and cache["x"] is captured
    graph = next(iter(compiled._held.values()))[1]
    assert all(v.data_ptr() == b.data_ptr() for v, b in zip((warm, captured), graph.inputs * 2))


def _callers():
    """Each compiled call of the port, made and called once on small seeded
    inputs: (its maker, a call of it)."""
    cfg = ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=3, embedding_size=4,
                      h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True)
    rng = np.random.default_rng(4)
    b, k = 8, 2
    xi = torch.from_numpy(rng.integers(0, SIZES[3:], size=(k, b, 3)).astype(np.int32))
    xv = torch.from_numpy(rng.normal(size=(k, b, 3)).astype(np.float32))
    y, mask = torch.ones(k, b), torch.ones(k, b)
    tc = TrainConfig(batch_size=b, learning_rate=1e-2)
    opt = trainer.make_optimizer(tc)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    prune_kw = dict(emb_r=0.5, emb_corr=1.0, prune_fm=True, prune_deep=True, prune_r=True)
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    return {
        "make_train_step": (lambda: trainer.make_train_step(cfg, tc, opt), lambda f: f(
            params, state, {"xi": xi[0], "xv": xv[0], "y": y[0], "mask": mask[0]}, gen)),
        "make_multi_step": (lambda: trainer.make_multi_step(cfg, tc, opt),
                            lambda f: f(params, state, xi, xv, y, mask, gen)),
        "PruneRefresh": (lambda: trainer.PruneRefresh(prune_kw), lambda f: f(params, 0.3)),
        "make_eval_fn": (lambda: trainer.make_eval_fn(cfg), lambda f: f(params, xi[0], xv[0])),
        "make_scan_eval_fn": (lambda: trainer.make_scan_eval_fn(cfg),
                              lambda f: f(params, xi, xv)),
        "Predictor": (lambda: Predictor(params, cfg, device="cpu"),
                      lambda f: f.logits(xi[0].numpy(), xv[0].numpy())),
    }


@pytest.mark.parametrize("caller", ["make_train_step", "make_multi_step", "PruneRefresh",
                                    "make_eval_fn", "make_scan_eval_fn", "Predictor"])
def test_a_callers_graphs_are_freed_with_it(caller, monkeypatch):
    """A compiled call's graphs are freed when the call is, with Python's
    cyclic collector off: a reference cycle would leave them to the collector,
    which can free a graph in the middle of another capture, and CUDA ends a
    capture in which a graph is freed (the card stood in for on the CPU)."""
    from test_torch_tracing import _cuda_on_the_cpu
    _cuda_on_the_cpu(monkeypatch)
    monkeypatch.setattr(cuda_graph, "_on_card", lambda device: True)
    make, call = _callers()[caller]
    gc.collect()
    gc.disable()
    try:
        made = make()
        call(made)
        graph = weakref.ref(next(iter(made._graphs._held.values()))[1])
        assert len(made._graphs) == 1 and graph() is not None
        del made
        assert graph() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("name", _build.sources())
def test_every_kernel_source_registers_its_launch_counter(name):
    """Each ``csrc/<name>.cu``'s wrapper, ``ops/cuda/<name>.py``, registers a
    count of its launches under its name, which graphs keep through captures
    and ``profiling.counters`` reads."""
    module = importlib.import_module(f"xsdeepfwfm_deprecated_torch.ops.cuda.{name}")
    kernel = cuda_graph.KERNELS[name]
    assert kernel is getattr(module, name) and isinstance(kernel.launches, int)
    assert name in profiling.counters()["launches"]


@pytest.mark.cuda
def test_graphed_predictor_and_multi_step_on_the_card():
    """On the card: a dynamic-int8 Predictor at B=512 replays one graph a
    request with one tower launch each, equal to the eager forward to the bit;
    4 steps with dropout as one multi-step replay against 4 eager steps from
    the same state and generator, under deterministic algorithms (the
    scatter-add sorted, not atomic): equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    cfg = ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=3, embedding_size=4,
                      h_depth=2, deep_nodes=64, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True)
    rng = np.random.default_rng(1)
    b, k = 512, 4
    xi = rng.integers(0, SIZES[3:], size=(k, b, 3)).astype(np.int32)
    xv = rng.normal(size=(k, b, 3)).astype(np.float32)
    y = (rng.random((k, b)) < 0.4).astype(np.float32)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pred = Predictor(convert(params, cfg, "dynamic"))
    int8_mlp.launches = 0
    first, second = pred.logits(xi[0], xv[0]), pred.logits(xi[0], xv[0])
    assert int8_mlp.launches == 2 and len(pred._graphs) == 1
    with torch.inference_mode():
        eager = pred._fn(pred._model, torch.from_numpy(xi[0]).cuda(),
                         torch.from_numpy(xv[0]).cuda())
    assert np.array_equal(first, second) and np.array_equal(first, eager.cpu().numpy())

    tc = TrainConfig(batch_size=b, learning_rate=1e-2)
    opt = trainer.make_optimizer(tc)
    xi_k, xv_k, y_k = (torch.from_numpy(a).cuda() for a in (xi, xv, y))
    mask_k = torch.ones((k, b), device="cuda")
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (False, True):
            p = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
            s = opt.init(p)
            gen = torch.Generator(device="cuda").manual_seed(5)
            if graphed:
                multi = trainer.make_multi_step(cfg, tc, opt)
                multi(p, s, xi_k, xv_k, y_k, mask_k, gen)
                assert len(multi._graphs) == 1
            else:
                for i in range(k):
                    trainer.train_step(p, s, {"xi": xi_k[i], "xv": xv_k[i], "y": y_k[i],
                                              "mask": mask_k[i]}, cfg, tc, opt, generator=gen)
            runs.append(p)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, w in zip(*map(_tree.leaves, runs)):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_last_compiled_forms_equal_their_eager_forms_on_the_card(monkeypatch):
    """On the card, under deterministic algorithms, each form graphed against
    the same form eager (``cuda_graph._on_card`` made false for it), to the
    bit: a pruning multi-step group of 3 real steps in 4 (the fit's tail
    group; dropout on, one replay of its own graph) and a full group after
    it; ``HashMLPBaseline.fit`` (a replay a step); ``calibrate`` (a replay a
    batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from xsdeepfwfm_deprecated_torch.compression.quantization import calibrate
    from xsdeepfwfm_deprecated_torch.models.hash_mlp_baseline import HashMLPBaseline
    cfg = ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=3, embedding_size=4,
                      h_depth=2, deep_nodes=64, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True)
    rng = np.random.default_rng(2)
    b, k = 512, 4
    xi = rng.integers(0, SIZES[3:], size=(k, b, 3)).astype(np.int32)
    xv = rng.normal(size=(k, b, 3)).astype(np.float32)
    y = (rng.random((k, b)) < 0.4).astype(np.float32)
    mask = np.ones((k, b), np.float32)
    mask[3] = 0.0
    tc = TrainConfig(batch_size=b, learning_rate=1e-2, weight_decay=1e-4)
    opt = trainer.make_optimizer(tc)
    prune_kw = dict(emb_r=0.5, emb_corr=1.0, prune_fm=True, prune_deep=True, prune_r=True)
    index = rng.integers(0, 1000, size=(4096, 26))
    value = rng.normal(size=(4096, 13)).astype(np.float32)
    labels = (rng.random(4096) < 0.3).astype(np.float32)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for graphed in (True, False):
            if not graphed:
                monkeypatch.setattr(cuda_graph, "_on_card", lambda device: False)
            p = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
            s = opt.init(p)
            gen = torch.Generator(device="cuda").manual_seed(5)
            multi = trainer.make_multi_step(cfg, tc, opt, prune_kw=prune_kw)
            inputs = [torch.from_numpy(a).cuda() for a in (xi, xv, y)]
            losses = [multi(p, s, *inputs, torch.from_numpy(m).cuda(), gen, None, a, k_real=kr)
                      for m, a, kr in ((mask, 0.3, 3), (np.ones_like(mask), 0.5, 4))]
            assert len(multi._graphs) == (2 if graphed else 0) and float(losses[0][3]) == 0.0
            base = HashMLPBaseline(train_cfg=TrainConfig(n_epochs=2, batch_size=1024,
                                                         learning_rate=1e-3))
            base.fit(index, value, labels)
            scales = calibrate(p, cfg, xi.reshape(-1, 3), xv.reshape(-1, 3), batch_size=256)
            runs.append(_tree.leaves((p, s, losses, base.params, scales)) + [gen.get_state()])
    finally:
        torch.use_deterministic_algorithms(False)
    for a, w in zip(*runs):
        assert torch.equal(a.cpu(), w.cpu())
