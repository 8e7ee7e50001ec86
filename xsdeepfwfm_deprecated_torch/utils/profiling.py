"""Profiling and timing: the program's spans and counters, chrome traces, timers.

Port of ``xsdeepfwfm_deprecated_tpu/utils/profiling.py:19-178`` with the same
names and signatures; every timer returns seconds per call.

* :func:`named_scope` is the program's one span. Tracing is off by default,
  and then it returns one shared null context: no clock is read and nothing
  is allocated. :func:`tracing` turns it on (``tracing(True)``, or ``with
  tracing():`` for a block). Each span is then kept in memory as a
  :class:`Span` on ``time.perf_counter_ns``'s clock, with the innermost span
  open in its thread as its parent and the current unit (one request or one
  step: a span opened with ``unit=True`` starts one) as its ``unit_id``.
  :func:`spans` returns the recorded spans and clears them;
  :func:`trace_clock_ns` puts a time on the clock of ``torch.profiler``'s
  chrome trace (``ts * 1000 + baseTimeNanoseconds``, Unix time in ns), from
  one ``(perf_counter_ns, time_ns)`` pair taken when tracing turned on;
  :func:`self_ms` gives each span's time less what its children cover.
* Inside a CUDA graph capture (:class:`.cuda_graph.Graphed`) with tracing
  on, a span is a pair of timing events captured into the graph as event
  record nodes (``external=True``), and the graph's :class:`DeviceSpans`
  turns each replay's events into spans named ``device:<name>`` with the
  replay's unit. A replay's events are read before the next replay
  overwrites them: where the last of them has completed (a request, which
  waits for its copy out), without a wait; otherwise the host waits for one
  replay in :data:`READ_EVERY` of that graph, a span ``trace.read`` of its
  own, and the others go unread. A graph captured with tracing off holds no
  events: :class:`.cuda_graph.Compiled` keeps a traced variant beside it.
* :func:`counters` reads the graphs' capture counts by name, the kernels'
  launches (:class:`.cuda_graph.Counter`), the bytes the mesh's collectives
  sent (``exchange_bytes``) and the counts kept on the card
  (:func:`.cuda_graph.device_count`, such as the bag rows Adagrad updated),
  which it alone reads back.
* :func:`trace` runs ``torch.profiler.profile`` over the block with tracing
  on, and exports a chrome trace into ``trace_dir`` with the program's spans
  in it (host spans on a row of their own, device spans on another). A
  profiler failure is raised.
* :func:`simple_timeit` is the host clock with a device sync per call: what
  a caller sees.
* :func:`marginal_timeit` and :func:`scan_timeit` return the device's seconds
  per forward of the compiled forward, as the JAX versions do. Those compile
  several forwards into one dispatch (a straight line of ``k1`` and of ``k2``
  forwards; a ``lax.scan`` of ``iters`` forwards); on the card the
  counterpart is a CUDA graph (:class:`.cuda_graph.Graphed`), and each replay
  is timed between two CUDA events. ``marginal_timeit`` captures one graph of
  ``k1`` and one of ``k2`` of the distinct inputs and returns JAX's marginal
  ``(min t(k2) - min t(k1)) / (k2 - k1)`` over ``reps``; ``scan_timeit``
  captures a chunk of back-to-back forwards of one input and replays it
  ``iters / chunk`` times, the median of ``reps`` over ``iters``. The graphs,
  and the activations they hold, are freed when the timer returns. A capture
  that fails raises: nothing gives way to eager forwards on the card. On the
  CPU both run the forwards eagerly by the host clock (``marginal_timeit``
  the least of ``reps`` runs of the ``k2`` inputs, over ``k2``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# the reference's profiler span names (model/DeepFMs.py:294,340,351,362,365,395)
SCOPE_FM = "FM - Component"
SCOPE_FWLW = "FM FW LW"
SCOPE_OUTER_FM = "FM Outer FM"
SCOPE_OUTER_FWFM = "FM Outer FwFM"
SCOPE_SECOND_ORDER = "FM Second Order"
SCOPE_DEEP = "Deep - Component"
SCOPE_CIN = "CIN - Component"          # xDeepFM's CIN; a "CIN - Layer {k}" span a layer inside
SCOPE_BAGS_LOOKUP = "Bags - Lookup"     # DLRM-DCNv2's pooled lookup of its multi-hot bags
SCOPE_BAGS_UPDATE = "Bags - Update"     # their rows' sum-and-Adagrad in the optimizer
SCOPE_DCN = "DCN - Component"           # its cross network; a "DCN - Layer {k}" span a layer inside
# a sharded DLRM-DCNv2 step's exchanges (parallel/bag_sharding): the global batch's ids to every
# rank, the row blocks' partial bags reduce-scattered to the examples' ranks, the bags' gradients
# gathered to every rank, the dense gradients all-reduced
SCOPE_BAGS_IDS_EXCHANGE = "Bags - Ids Exchange"
SCOPE_BAGS_POOL_EXCHANGE = "Bags - Pool Exchange"
SCOPE_BAGS_GRAD_EXCHANGE = "Bags - Grad Exchange"
SCOPE_DENSE_ALL_REDUCE = "Dense - All Reduce"

DEVICE = "device:"     # the name prefix of a span read from a graph's events
READ_EVERY = 16        # a graph still running at its next replay: one replay in this many is read
TRACE_FILE = "trace.json"
SCAN_CHUNK = 10   # forwards a graph of scan_timeit: about 10**3 nodes at B=1, quick to instantiate


class Span(NamedTuple):
    """One recorded span; times are ``time.perf_counter_ns()``, ids start at 1
    and a ``parent_id`` of 0 is none."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int
    unit_id: int


class _Tracer:
    """The process's tracing state: whether spans are recorded, the spans
    recorded and not yet drained, the ids, the clock pair and each thread's
    open spans and capture."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.ids = itertools.count(1)
        self.unit = 0
        self.offset_ns = 0              # time_ns - perf_counter_ns, taken when tracing turns on
        self.unread: Dict[int, "DeviceSpans"] = {}     # graphs whose last replay is unread
        self.anchors: Dict[str, Tuple[torch.cuda.Event, int]] = {}   # per card
        self.local = threading.local()  # .open: open span ids; .capture: a capture's scopes

    def open_spans(self) -> List[int]:
        stack = getattr(self.local, "open", None)
        if stack is None:
            stack = self.local.open = []
        return stack


_T = _Tracer()
_NULL = contextlib.nullcontext()


class _HostScope:
    __slots__ = ("name", "unit", "start", "span_id", "parent_id", "unit_id")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = _T.open_spans()
        self.parent_id = stack[-1] if stack else 0
        if self.unit:
            _T.unit += 1
        self.unit_id = _T.unit
        self.span_id = next(_T.ids)
        stack.append(self.span_id)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _T.open_spans().pop()
        _T.spans.append(Span(self.name, self.start, end, self.span_id, self.parent_id,
                             self.unit_id))


class _DeviceScope:
    """A span inside a capture: a pair of timing events captured into the graph."""
    __slots__ = ("name", "capture", "index")

    def __init__(self, name: str, capture: "DeviceSpans"):
        self.name, self.capture = name, capture

    def __enter__(self):
        self.index = self.capture.open(self.name)

    def __exit__(self, *exc):
        self.capture.close(self.index)


def named_scope(name: str, *, unit: bool = False):
    """A span named ``name`` over the ``with`` block; ``unit`` starts a new
    unit (a request, a step) that the spans opened after it share. Off, the
    shared null context."""
    if not _T.on:
        return _NULL
    capture = getattr(_T.local, "capture", None)
    if capture is not None:
        return _DeviceScope(name, capture)
    return _HostScope(name, unit)


def enabled() -> bool:
    return _T.on


class tracing:
    """``tracing(True)`` turns the program's spans on and ``tracing(False)``
    off, at once; as a context manager it turns them back to what they were
    when the block ends."""

    def __init__(self, on: bool = True):
        self.before = _T.on
        _set(on)

    def __enter__(self) -> "tracing":
        return self

    def __exit__(self, *exc) -> None:
        _set(self.before)


def _set(on: bool) -> None:
    if on and not _T.on:
        _T.offset_ns = time.time_ns() - time.perf_counter_ns()
    _T.on = on


def trace_clock_ns(perf_ns: int) -> int:
    """A ``perf_counter_ns`` time on the chrome trace's clock (Unix ns)."""
    return perf_ns + _T.offset_ns


def spans() -> List[Span]:
    """The spans recorded since the last call, oldest end first, and clears
    them; a graph's last replay not yet read is waited for and read first."""
    return _drain(0)


def _drain(mark: int) -> List[Span]:
    """The spans recorded after the first ``mark``, the graphs' unread
    replays read first; those before ``mark`` stay."""
    for d in list(_T.unread.values()):
        d.read(wait=True)
    out, _T.spans = _T.spans[mark:], _T.spans[:mark]
    return out


def self_ms(recorded: Sequence[Span], name: str) -> List[float]:
    """Each span named ``name``: its duration less the part of it that its
    children cover, in ms."""
    children: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in recorded:
        children[s.parent_id].append(s)
    out = []
    for s in recorded:
        if s.name != name:
            continue
        covered, reach = 0, s.start_ns
        for c in sorted(children[s.span_id], key=lambda c: c.start_ns):
            a, b = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out.append((s.end_ns - s.start_ns - covered) * 1e-6)
    return out


def _anchor(device: torch.device) -> Tuple[torch.cuda.Event, int]:
    """A timing event recorded on the idle card and the host's
    ``perf_counter_ns`` at that moment: device times measured from it are
    host times. Made once a card."""
    key = str(device)
    if key not in _T.anchors:
        torch.cuda.synchronize(device)
        event = torch.cuda.Event(enable_timing=True)
        before = time.perf_counter_ns()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()
        _T.anchors[key] = (event, (before + time.perf_counter_ns()) // 2)
    return _T.anchors[key]


class DeviceSpans:
    """The spans of one traced capture, as timing events in its graph, and
    the reading of each replay's events into ``device:`` spans."""

    def __init__(self, device: torch.device):
        self.anchor = _anchor(device)
        self.scopes: List[list] = []    # [name, start event, end event, parent index]
        self.open_scopes: List[int] = []
        self.last: Optional[torch.cuda.Event] = None   # the event the graph records last
        self.replays = 0
        self.pending: Optional[Tuple[int, int]] = None  # (replay number, unit) unread

    def _event(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.last = event
        return event

    def open(self, name: str) -> int:
        parent = self.open_scopes[-1] if self.open_scopes else -1
        self.scopes.append([name, self._event(), None, parent])
        self.open_scopes.append(len(self.scopes) - 1)
        return self.open_scopes[-1]

    def close(self, index: int) -> None:
        self.open_scopes.pop()
        self.scopes[index][2] = self._event()

    def before_replay(self) -> None:
        """Read the last replay's events, before this replay overwrites them."""
        if self.pending is not None:
            self.read(wait=self.pending[0] % READ_EVERY == 1)

    def replayed(self) -> None:
        """Hold this replay's unit until its events are read."""
        self.replays += 1
        if _T.on:
            self.pending = (self.replays, _T.unit)
            _T.unread[id(self)] = self

    def read(self, wait: bool) -> None:
        """Turn the unread replay's events into spans (a ``trace.read`` span):
        at once where they have completed; else after a wait with ``wait``,
        or not at all."""
        pending, self.pending = self.pending, None
        _T.unread.pop(id(self), None)
        if pending is None or not _T.on:
            return
        done = self.last.query()
        if not (done or wait):
            return
        with named_scope("trace.read"):
            if not done:
                self.last.synchronize()
            # the replay placed by the anchor, each event timed from the replay's first
            anchor, anchor_ns = self.anchor
            first = self.scopes[0][1]
            at = anchor_ns + round(anchor.elapsed_time(first) * 1e6)
            ids = [next(_T.ids) for _ in self.scopes]
            for (name, start, end, parent), span_id in zip(self.scopes, ids):
                _T.spans.append(Span(DEVICE + name,
                                     at + (0 if start is first
                                           else round(first.elapsed_time(start) * 1e6)),
                                     at + round(first.elapsed_time(end) * 1e6),
                                     span_id, ids[parent] if parent >= 0 else 0, pending[1]))


@contextlib.contextmanager
def capturing(device: torch.device):
    """Around a CUDA graph capture on ``device``: with tracing on, the spans
    opened in this thread become timing events in the graph, and the
    :class:`DeviceSpans` that reads them is yielded; with tracing off, None."""
    if not _T.on:
        yield None
        return
    capture = DeviceSpans(device)
    _T.local.capture = capture
    try:
        yield capture
    finally:
        _T.local.capture = None


def counters(**extra) -> Dict[str, Dict]:
    """What the program has counted: the graphs captured, by name (every
    :class:`.cuda_graph.Compiled` counts its captures), the launches of each
    kernel of ``cuda_graph.KERNELS``, ``exchange_bytes`` (the bytes this
    process's collectives must send from it, ``parallel.mesh.Mesh``; through
    graph replays as the launches; 0 on one device), each count kept on the
    card by name (``bag_rows_updated``: the distinct table rows the bags'
    Adagrad stepped; read back here, with a sync), and the mark of each
    :class:`.cuda_graph.Counter` given by name in ``extra`` (a ``Log``'s
    entry count)."""
    from . import cuda_graph
    return {"captures": dict(collections.Counter(name for name, _ in cuda_graph.CAPTURES)),
            "launches": {name: k.launches for name, k in cuda_graph.KERNELS.items()},
            "exchange_bytes": cuda_graph.EXCHANGE_BYTES.value,
            "on_card": cuda_graph.device_counts(),
            **({"extra": {k: c.mark() for k, c in extra.items()}} if extra else {})}


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile the block with the program's tracing on and write
    ``<trace_dir>/trace.json`` (the reference's
    ``export_chrome_trace('trace.json')``), the program's spans in it.
    ``None`` profiles nothing."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, TRACE_FILE)
    mark = len(_T.spans)            # spans recorded before the block stay for spans()
    with tracing():
        with profile(activities=activities) as prof:
            yield
        recorded = _drain(mark)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(recorded, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


def _chrome_events(recorded: Sequence[Span], base_ns: int) -> List[Dict]:
    """The spans as chrome trace events (``user_annotation``) on the trace's
    clock, whose ``ts`` is µs after ``base_ns``: host spans on one row of
    this process, device spans on another."""
    pid = os.getpid()
    rows = {False: (0, "program spans"), True: (1, "program device spans")}
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": label}}
           for tid, label in rows.values()]
    for s in recorded:
        out.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                    "tid": rows[s.name.startswith(DEVICE)][0],
                    "ts": (trace_clock_ns(s.start_ns) - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                             "unit_id": s.unit_id}})
    return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def simple_timeit(fn: Callable, *args, tries: int = 10, warmup: int = 1,
                  task: str = "") -> float:
    """Mean host-clock seconds per call, each call followed by a device sync."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times: List[float] = []
    for _ in range(tries):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times)


def _on_cuda(tensors: Sequence) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def timed(run: Callable[[], None], cuda: bool) -> float:
    """Seconds ``run`` takes: between two CUDA events on the current stream,
    or by the host clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3


def _captured(fn: Callable, model, args_list: Sequence[tuple], name: str):
    """``fn(model, *args)`` for each argument tuple, captured into one CUDA
    graph on the inputs' device, with the inputs as its static buffers."""
    arity = len(args_list[0])
    flat = [t for args in args_list for t in args]

    def forwards(*xs):
        return [fn(model, *xs[i:i + arity]) for i in range(0, len(xs), arity)]
    from .cuda_graph import Graphed
    what = getattr(fn, "__qualname__", type(fn).__name__)
    return Graphed(forwards, flat, device=flat[0].device,
                   name=f"{name}'s {len(args_list)} forwards of {what}")


def marginal_timeit(fn: Callable, model, inputs, *, k1: int = 1, k2: int = 16,
                    reps: int = 7) -> float:
    """Device seconds per forward, straight-line regime: the marginal cost of
    one more forward in one dispatch.

    ``inputs`` is a list of at least ``k2`` DISTINCT argument tuples. On the
    card the first ``k1`` and the first ``k2`` of them are captured into one
    CUDA graph each; each replay is timed between two CUDA events, and
    ``(min t(k2) - min t(k1)) / (k2 - k1)`` over ``reps`` replays of each is
    returned, as the JAX version returns it for its two compiled dispatches.
    On the CPU the ``k2`` forwards run eagerly, and the least of ``reps``
    runs by the host clock, over ``k2``, is returned."""
    # a short list would run len(inputs) forwards and still divide by k2
    assert len(inputs) >= k2 > k1, \
        f"marginal_timeit needs >= k2={k2} distinct inputs, got {len(inputs)}"
    if not _on_cuda(inputs[0]):
        def run():
            for a in inputs[:k2]:
                fn(model, *a)

        run()
        return min(timed(run, False) for _ in range(reps)) / k2
    g1 = _captured(fn, model, inputs[:k1], "marginal_timeit")
    g2 = _captured(fn, model, inputs[:k2], "marginal_timeit")
    g1.replay()
    g2.replay()
    _sync()
    t1s, t2s = [], []
    for _ in range(reps):
        t1s.append(timed(g1.replay, True))
        t2s.append(timed(g2.replay, True))
    return (min(t2s) - min(t1s)) / (k2 - k1)


def scan_timeit(fn: Callable, model, xi, xv, *, iters: int = 100,
                reps: int = 3, warmup: bool = True) -> float:
    """Device seconds per forward of one input: ``iters`` forwards back to back
    in as few dispatches as a graph can hold, the median of ``reps`` runs.

    On the card a chunk of at most :data:`SCAN_CHUNK` forwards (the largest
    that divides ``iters``) is captured into one CUDA graph and replayed
    ``iters / chunk`` times between two CUDA events (``warmup``: one replay
    before). On the CPU the ``iters`` forwards run eagerly by the host clock
    (``warmup``: one forward before)."""
    if not _on_cuda((xi, xv)):
        def run_eager():
            for _ in range(iters):
                fn(model, xi, xv)

        if warmup:
            fn(model, xi, xv)
        times = sorted(timed(run_eager, False) for _ in range(reps))
        return times[len(times) // 2] / iters
    chunk = max(d for d in range(1, min(iters, SCAN_CHUNK) + 1) if iters % d == 0)
    graph = _captured(fn, model, [(xi, xv)] * chunk, "scan_timeit")

    def run():
        for _ in range(iters // chunk):
            graph.replay()

    if warmup:
        graph.replay()
        _sync()
    times = sorted(timed(run, True) for _ in range(reps))
    return times[len(times) // 2] / iters
