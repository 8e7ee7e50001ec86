"""What every loop shares: the run's record, the clocks, the profiler's
reduction and the card's description.

A loop (``loops/<name>.py``) fills a :class:`Record`; the metric readers
(``end_to_end/<metric>.py``, ``layer_metrics/<metric>.py``) take their numbers
from it. Spans are host-clock seconds around the benchmark's own calls into
the program; device times come from CUDA events the benchmark records; busy
and idle time from ``torch.profiler``'s trace.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def process_start() -> float:
    """The ``time.perf_counter()`` reading of the moment this process started
    (from ``/proc``; to the clock tick)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


@dataclass
class Context:
    """One run of one cell, as the command line and ``BENCHMARK.json`` give it."""
    cell: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    limits: Optional[Dict[str, float]]
    started: float                  # perf_counter at process start
    control: bool = False           # also read the control: the reference in lower precision
    stages: Dict[str, float] = field(default_factory=dict)  # set-up's stages, s from start

    def stage(self, name: str) -> None:
        """Mark the end of one stage of set-up."""
        self.stages[name] = time.perf_counter() - self.started


@dataclass
class Record:
    """What a run measured. Times in seconds unless a name says otherwise."""
    setup_s: float = 0.0
    window_s: float = 0.0
    examples: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: List[float] = field(default_factory=list)     # one per request
    spans: Dict[str, List[float]] = field(default_factory=dict)  # host-clock spans
    device_ms: Dict[str, List[float]] = field(default_factory=dict)  # CUDA-event times
    busy_s: Optional[float] = None     # the device's busy time in the profiled stretch
    traced_s: Optional[float] = None   # the profiled stretch's length
    traced_units: int = 0              # steps or requests in the profiled stretch
    breakdown: Optional[Dict] = None
    memory_peak_bytes: int = 0
    checks: Dict[str, float] = field(default_factory=dict)
    control_checks: Dict[str, float] = field(default_factory=dict)
    info: Dict = field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceTimer:
    """Pairs of CUDA events on the current stream; read after a sync."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.pairs: List[Tuple] = []

    def start(self):
        if not self.on_card:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def stop(self, start):
        """Close the pair ``start`` opened; the closing event, or None."""
        if start is None:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.append((start, e))
        return e

    def ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "port_bench.window"
TOP = 10
GAPS_NAMED = 2000


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted (start, end) rows."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def reduce_trace(events: List[Dict]) -> Tuple[float, float, Dict]:
    """(busy_s, window_s, breakdown) of a chrome trace: the union of the
    device's operations inside the window, its length, the operations that
    took most device time and the longest idle stretches by the innermost
    host call running over them. The window is the span named
    ``port_bench.window`` where the trace holds host operations; in a trace of
    the card alone it runs from the first runtime call or device operation to
    the end of the last."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != WINDOW]
    if win:
        w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    elif dev:
        w0 = min(float(e["ts"]) for e in dev + host)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev + host)
    else:
        raise RuntimeError("the profiler's trace holds no window and no device operation")
    iv = np.array([[max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)]
                   for e in dev], dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    busy = _union(iv)
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    by_op: Dict[str, float] = {}
    for e in dev:
        name = str(e.get("name", "?"))[:120]
        by_op[name] = by_op.get(name, 0.0) + float(e["dur"]) * 1e-6
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])]          # longest first
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    by_host: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        name = "shorter gaps"
        if i < GAPS_NAMED and len(host):
            mid = 0.5 * (a + b)
            over = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (str(host[over[np.argmin(he[over] - hs[over])]]["name"])[:120]
                    if len(over) else "no host call")
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    return busy_us * 1e-6, (w1 - w0) * 1e-6, {"device_ops": _top(by_op), "idle_gaps": _top(by_host)}


def _top(seconds: Dict[str, float]) -> List[List]:
    return sorted(([k, v] for k, v in seconds.items()), key=lambda kv: -kv[1])[:TOP]


def profile(fn: Callable[[], None], units: int, device: torch.device, rec: Record) -> None:
    """Run ``fn``, ``units`` of the window's steps or requests, under
    ``torch.profiler`` after the window, and put the device's busy time, the
    stretch's length, ``units`` and the breakdown into ``rec``. On the card
    only the card's activity is traced: kernels, copies, memsets and the
    runtime calls that issue them."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    sync(device)
    with torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    rec.busy_s, rec.traced_s, rec.breakdown = reduce_trace(events)
    rec.traced_units = units


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi not read: {err}"
