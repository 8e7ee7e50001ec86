"""Profiling and timing: named spans, chrome traces, timers.

Port of ``xsdeepfwfm_deprecated_tpu/utils/profiling.py:19-178`` with the same
names and signatures; every timer returns seconds per call.

* :func:`named_scope` is ``torch.profiler.record_function`` under the
  reference's six span names.
* :func:`trace` runs ``torch.profiler.profile`` over the block and exports a
  chrome trace into ``trace_dir``. A profiler failure is raised.
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

import contextlib
import os
import time
from typing import Callable, List, Optional, Sequence

import torch

from .cuda_graph import Graphed

# the reference's profiler span names (model/DeepFMs.py:294,340,351,362,365,395)
SCOPE_FM = "FM - Component"
SCOPE_FWLW = "FM FW LW"
SCOPE_OUTER_FM = "FM Outer FM"
SCOPE_OUTER_FWFM = "FM Outer FwFM"
SCOPE_SECOND_ORDER = "FM Second Order"
SCOPE_DEEP = "Deep - Component"

TRACE_FILE = "trace.json"
SCAN_CHUNK = 10   # forwards a graph of scan_timeit: about 10**3 nodes at B=1, quick to instantiate


def named_scope(name: str):
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile the block and write ``<trace_dir>/trace.json`` (the reference's
    ``export_chrome_trace('trace.json')``). ``None`` profiles nothing."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


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


def _captured(fn: Callable, model, args_list: Sequence[tuple], name: str) -> Graphed:
    """``fn(model, *args)`` for each argument tuple, captured into one CUDA
    graph on the inputs' device, with the inputs as its static buffers."""
    arity = len(args_list[0])
    flat = [t for args in args_list for t in args]

    def forwards(*xs):
        return [fn(model, *xs[i:i + arity]) for i in range(0, len(xs), arity)]
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
