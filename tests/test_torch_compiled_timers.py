"""The port's timers time the compiled forward, as the JAX timers time the
jitted one: on the card ``marginal_timeit`` and ``scan_timeit`` capture their
forwards into CUDA graphs and time replays, ``run_benchmark``'s host-clock
numbers go through ``Predictor.replay``, and ``qr_scale_run.train_step_ms``
times ``make_multi_step`` dispatches.

On the CPU, the card's branch of the timers is forced by their own test of
the inputs' device (``utils.profiling._on_cuda``), with CUDA's graphs,
capture, streams and events replaced by stand-ins: a captured graph counts
the forwards recorded into it, a replay advances a device clock by 1 ms a
forward, and an event reads that clock.
"""

import collections
import contextlib
import logging
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from test_torch_cuda_graph import _FakeStream
from test_torch_serving import _batch, _port
from xsdeepfwfm_deprecated_tpu.compression import quantization as JQ
from xsdeepfwfm_deprecated_tpu.config import ModelConfig as JConfig
from xsdeepfwfm_deprecated_tpu.models import deepfwfm as JD
from xsdeepfwfm_deprecated_tpu.serving import benchmark as JB
from xsdeepfwfm_deprecated_tpu.serving.predictor import Predictor as JPredictor
from xsdeepfwfm_deprecated_torch.compression import quantization as TQ
from xsdeepfwfm_deprecated_torch.config import ModelConfig
from xsdeepfwfm_deprecated_torch.serving import benchmark as TB
from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor as TPredictor
from xsdeepfwfm_deprecated_torch.tools import qr_scale_run as t_qr
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import profiling as TP

FLAGS = dict(use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)
SIZES = (1, 1, 30, 40, 50)


class _Card:
    """The card's stand-ins and what happened on them, in order, in ``log``:
    "forward" for a forward run eagerly, "captured" for one recorded into a
    graph, "replay", and "record" for each event of a timed window."""

    def __init__(self):
        self.log = []
        self.clock = 0.0
        self.capturing = None
        self.in_window = False
        self.graphs = []            # weak references to every graph made
        self.window_calls = []      # torch functions called inside a timed window

    def note_forward(self):
        if self.capturing is not None:
            self.capturing.forwards += 1
            self.log.append("captured")
        else:
            self.log.append("forward")

    def forward(self, model, x, *rest):
        self.note_forward()
        return x.sum(dim=-1)

    def windows(self):
        """What happened between the two events of each timed window."""
        out, cur = [], None
        for entry in self.log:
            if entry == "record":
                cur, done = ([], None) if cur is None else (None, cur)
                if done is not None:
                    out.append(done)
            elif cur is not None:
                cur.append(entry)
        return out


@pytest.fixture
def card(monkeypatch):
    c = _Card()

    class Graph:
        def __init__(self):
            self.forwards = 0
            c.graphs.append(weakref.ref(self))

        def register_generator_state(self, gen):
            pass

        def replay(self):
            c.log.append("replay")
            c.clock += self.forwards

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = c.clock
            c.in_window = not c.in_window
            c.log.append("record")

        def elapsed_time(self, end):
            return end.t - self.t

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        c.capturing = graph
        try:
            yield
        finally:
            c.capturing = None

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(TP, "_on_cuda", lambda tensors: True)
    return c


class _WindowCalls(TorchFunctionMode):
    """Notes every torch function called while a timed window is open: an
    eager forward calls dozens, a replay none."""

    def __init__(self, card):
        super().__init__()
        self.card = card

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.card.in_window:
            self.card.window_calls.append(getattr(func, "__name__", repr(func)))
        return func(*args, **(kwargs or {}))


def test_marginal_timeit_times_replays_of_two_captured_graphs(card):
    """A graph of the first k1 inputs and one of the first k2: each forward
    runs once in the warm-up and once into the capture, then each graph is
    replayed once; every timed window holds one replay and nothing else, and
    JAX's marginal ``(min t(k2) - min t(k1)) / (k2 - k1)`` is returned (1 ms
    a forward on the stand-ins' clock). The graphs are gone on return."""
    inputs = [(torch.full((4, 3), float(i)),) for i in range(8)]
    t = TP.marginal_timeit(card.forward, None, inputs, k1=2, k2=8, reps=3)
    set_up = card.log[:card.log.index("record")]
    assert set_up == (["forward"] * 2 + ["captured"] * 2 + ["forward"] * 8 + ["captured"] * 8
                      + ["replay"] * 2)
    assert card.windows() == [["replay"]] * 6
    assert t == pytest.approx(1e-3, rel=1e-12)
    assert len(card.graphs) == 2 and all(ref() is None for ref in card.graphs)


@pytest.mark.parametrize("iters,chunk", [(30, 10), (7, 7), (26, 2)])
def test_scan_timeit_replays_a_chunk_of_forwards_in_each_window(card, iters, chunk):
    """One graph of ``chunk`` forwards of the one input (the largest count
    up to ``SCAN_CHUNK`` that divides ``iters``), a warm-up replay, then
    ``reps`` windows of ``iters / chunk`` replays and nothing else; the
    median over ``iters``. The graph is gone on return."""
    xi, xv = torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, 3)
    t = TP.scan_timeit(lambda m, a, b: card.forward(m, b), None, xi, xv, iters=iters, reps=3)
    set_up = card.log[:card.log.index("record")]
    assert set_up == ["forward"] * chunk + ["captured"] * chunk + ["replay"]
    assert card.windows() == [["replay"] * (iters // chunk)] * 3
    assert t == pytest.approx(1e-3, rel=1e-12)
    assert len(card.graphs) == 1 and card.graphs[0]() is None


@pytest.mark.parametrize("timer", ["marginal", "scan"])
def test_a_failed_capture_raises_and_times_nothing(card, monkeypatch, timer):
    """A capture that fails raises, naming the timer's forwards; no window
    is timed, and no forward runs eagerly after it."""

    @contextlib.contextmanager
    def failing(graph, stream=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is capturing")
        yield

    monkeypatch.setattr(torch.cuda, "graph", failing)
    x = torch.ones(2, 3)
    with pytest.raises(RuntimeError, match=f"{timer}_timeit's .* forwards of .* cannot be "
                                           "captured into a CUDA graph"):
        if timer == "marginal":
            TP.marginal_timeit(card.forward, None, [(x,)] * 4, k2=4)
        else:
            TP.scan_timeit(lambda m, a, b: card.forward(m, b), None, x, x, iters=20)
    n_warm = 1 if timer == "marginal" else 10     # the k1 graph's warm-up, or the chunk's
    assert card.log == ["forward"] * n_warm


def _flagship_family(seed=0):
    kw = dict(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=4,
              h_depth=2, deep_nodes=16, **FLAGS)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    return jcfg, tcfg, JD.init_params(jax.random.PRNGKey(seed), jcfg)


def _quiet():
    log = logging.getLogger("test_torch_compiled_timers")
    log.propagate = False
    return log


def test_run_benchmark_times_replays_and_the_predictors_replay(card, monkeypatch):
    """``run_benchmark`` with the timers on the card's branch: ``batch_ms``
    and ``single_example_ms`` call ``Predictor.replay`` (21 calls at B=32, 8
    at B=1); every window of ``marginal_timeit`` and ``scan_timeit`` (the
    op-level rows', the batch's, the single example's) holds replays and no
    torch function; every graph is gone at the end; and the result has the
    JAX package's key set."""
    jcfg, tcfg, params = _flagship_family()
    xi, xv = _batch(SIZES, 2, 100, seed=1)
    y = (np.random.default_rng(1).random(100) < 0.3).astype(np.float32)
    pred = TPredictor(_port(params), tcfg, device="cpu")
    inner = pred._fn

    def counted(model, a, b):
        card.note_forward()
        return inner(model, a, b)
    pred._fn = counted
    timed_replays = collections.Counter()
    in_simple = []
    replay, simple_timeit = TPredictor.replay, TB.simple_timeit

    def spy_replay(self, a, b):
        if in_simple:
            timed_replays[a.shape[0]] += 1
        return replay(self, a, b)

    def simple(fn, *args, **kw):
        in_simple.append(True)
        try:
            return simple_timeit(fn, *args, **kw)
        finally:
            in_simple.pop()
    monkeypatch.setattr(TPredictor, "replay", spy_replay)
    monkeypatch.setattr(TB, "simple_timeit", simple)
    with _WindowCalls(card):
        got = TB.run_benchmark(pred, xi, xv, y, batch_size=32, n_single=5,
                               logger=_quiet())
    assert timed_replays == {32: 21, 1: 8}
    assert card.window_calls == []
    windows = card.windows()
    # op_summary: 4 rows x 5 reps x 2 graphs; the batch: 5 x 2; the single example: 3
    assert len(windows) == 53 and all(w and set(w) == {"replay"} for w in windows)
    assert all(ref() is None for ref in card.graphs)
    assert got["batch_onchip_ms"] == pytest.approx(1.0) and got["examples_per_s"] > 0
    want = JB.run_benchmark(JPredictor(params, jcfg, layout="flat"), xi, xv, y,
                            batch_size=32, n_single=5, logger=None)
    assert set(got) == set(want) - {"bytes_accessed_per_batch"}


@pytest.mark.parametrize("mode", ["fp32", "dynamic"])
def test_replay_equals_logits_and_the_jax_predictor(mode):
    """``Predictor.replay`` on tensors gives a tensor equal to ``logits`` to
    the bit, and to the JAX ``Predictor`` on carried-across weights within
    the serving tests' tolerances: rtol/atol 1e-5 in fp32 (float32 sums in
    another order), atol 1e-4 in dynamic int8 (XLA multiplies by 1/127 where
    the port divides)."""
    jcfg, tcfg, params = _flagship_family(seed=2)
    xi, xv = _batch(SIZES, 2, 256, seed=3)
    if mode == "fp32":
        pred, want = (TPredictor(_port(params), tcfg, device="cpu"),
                      JPredictor(params, jcfg).logits(xi, xv))
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        pred = TPredictor(TQ.convert(_port(params), tcfg, mode="dynamic"), device="cpu")
        want = JPredictor(JQ.convert(params, jcfg, mode="dynamic")).logits(xi, xv)
        tol = dict(rtol=0, atol=1e-4)
    got = pred.replay(torch.from_numpy(xi), torch.from_numpy(xv))
    assert isinstance(got, torch.Tensor) and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), pred.logits(xi, xv))
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_qr_train_step_ms_times_multi_step_dispatches(monkeypatch):
    """``train_step_ms`` builds one ``make_multi_step`` of K steps and calls it
    six times (a warm-up, then the 5 timed) on the K stacked seeded batches,
    with ``k_real`` set (no read of the mask back) and the same state each
    time; on the CPU its K steps run eagerly, K ``train_step`` s a call."""
    sizes = (1,) * 13 + tuple(int(s) for s in np.random.default_rng(0).integers(10, 500, 26))
    mcfg = ModelConfig(field_size=39, feature_sizes=sizes, numerical=13, embedding_size=4,
                       h_depth=1, deep_nodes=8, **FLAGS)
    made, calls, steps = [], [], []
    make = t_qr.make_multi_step

    def spy_make(mcfg_, tcfg, optimizer, **kw):
        made.append((mcfg_, tcfg.batch_size, tcfg.steps_per_call, kw))
        multi = make(mcfg_, tcfg, optimizer, **kw)

        def call(params, opt_state, xi_k, *rest, **kwargs):
            calls.append((id(params), id(opt_state), tuple(xi_k.shape), kwargs))
            return multi(params, opt_state, xi_k, *rest, **kwargs)
        return call

    train_step = trainer.train_step

    def spy_step(*args, **kw):
        steps.append(1)
        return train_step(*args, **kw)
    monkeypatch.setattr(t_qr, "make_multi_step", spy_make)
    monkeypatch.setattr(trainer, "train_step", spy_step)
    ms = t_qr.train_step_ms(mcfg, k=2, b=64, device="cpu")
    assert made == [(mcfg, 64, 2, {})]
    assert len(calls) == 6 and len({c[:2] for c in calls}) == 1
    assert all(c[2:] == ((2, 64, 26), {"k_real": 2}) for c in calls)
    assert len(steps) == 12 and np.isfinite(ms) and ms > 0
