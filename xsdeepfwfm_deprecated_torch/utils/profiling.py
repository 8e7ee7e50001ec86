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
  per forward. The JAX versions got that number from a TPU behind a remote
  link by compiling several forwards into one dispatch (a straight line of
  ``k2`` forwards less one of ``k1``; a ``lax.scan`` of ``iters`` forwards) so
  that the link's round trip cancelled. Here the device is local and CUDA
  events time it directly: same quantity, same arguments, no ``lax.scan``.
  ``marginal_timeit`` times the ``k2`` distinct inputs between two events
  (the least of ``reps``), ``scan_timeit`` ``iters`` back-to-back forwards of
  one input on one stream (the median of ``reps``). On the CPU both use the
  host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional, Sequence

import torch

# the reference's profiler span names (model/DeepFMs.py:294,340,351,362,365,395)
SCOPE_FM = "FM - Component"
SCOPE_FWLW = "FM FW LW"
SCOPE_OUTER_FM = "FM Outer FM"
SCOPE_OUTER_FWFM = "FM Outer FwFM"
SCOPE_SECOND_ORDER = "FM Second Order"
SCOPE_DEEP = "Deep - Component"

TRACE_FILE = "trace.json"


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


def marginal_timeit(fn: Callable, model, inputs, *, k1: int = 1, k2: int = 16,
                    reps: int = 7) -> float:
    """Device seconds per forward over ``k2`` DISTINCT inputs.

    ``inputs`` is a list of at least ``k2`` argument tuples. The forwards are
    issued one after the other between two CUDA events; the least of ``reps``
    runs, over ``k2``, is returned. ``k1`` is kept for the signature."""
    # a short list would run len(inputs) forwards and still divide by k2
    assert len(inputs) >= k2 > k1, \
        f"marginal_timeit needs >= k2={k2} distinct inputs, got {len(inputs)}"
    cuda = _on_cuda(inputs[0])

    def run():
        for a in inputs[:k2]:
            fn(model, *a)

    run()
    _sync()
    return min(timed(run, cuda) for _ in range(reps)) / k2


def scan_timeit(fn: Callable, model, xi, xv, *, iters: int = 100,
                reps: int = 3, warmup: bool = True) -> float:
    """Device seconds per forward of one input: ``iters`` forwards back to back
    on one stream between two CUDA events, the median of ``reps`` runs."""
    cuda = _on_cuda((xi, xv))

    def run():
        for _ in range(iters):
            fn(model, xi, xv)

    if warmup:
        fn(model, xi, xv)
        _sync()
    times = sorted(timed(run, cuda) for _ in range(reps))
    return times[len(times) // 2] / iters
