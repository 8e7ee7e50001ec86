"""The program's own spans (the port's ``utils/profiling``) in a ``--trace 1``
run: one more stretch, after the loop has returned, with the program's
tracing on.

A loop's ``--trace 1`` run ends with the window and a profiled stretch, both
with tracing off, and frees what it built. The first reader of a span metric
(``layer_metrics/<metric>.py``) calls :func:`stretch`, which builds the cell
again from the run's seed as its loop builds it (weights, pool, ``Predictor``
or train step, refresh and feed), captures the traced variant of its graphs
with a few requests or one step, and then runs as many requests or steps as
the loop's profiled stretch twice: first without a profiler, which the
metrics read, then under the same ``torch.profiler`` (the card's activity
alone), which names the idle time. The profiler's hooks slow every runtime
call on the host and every node of a graph on the card, and the trace it
leaves behind slows the host's allocations, so the metrics' part comes
first. There a step is followed by a sync, so that no call into CUDA waits
for the card and each replay's events are read; a request waits for its
answer anyway. A training stretch takes the refresh's schedule on from where
the loop's stretch left it. The spans are kept on the record for the other readers, and
the run's lines get, besides the metrics:

* ``breakdown["idle_gaps_by_span"]``: the stretch's idle gaps, as
  ``idle_gaps`` forms them, each named by the innermost program host span
  open over its midpoint on the trace's clock, ``no program span`` where
  none is;
* ``info graph_captures_in_window``: the program's graph captures between
  the window's start and end (read from ``cuda_graph.CAPTURES``);
* ``info program_spans`` and ``info profiled_spans``: each span name's
  count, mean ms and mean self ms without the profiler and under it;
  ``info graph_launches_in_spans``: the share of the profiled part's
  ``cudaGraphLaunch`` calls that lie inside a ``request.launch``,
  ``train.step`` or ``train.refresh`` span; ``info idle_named_by_span``: the
  share of its idle time that a program span names; ``info runtime_calls_ms``:
  its five CUDA runtime calls with the most host time, ms a unit.

A program without tracing (no ``profiling.tracing``) gives nothing: every
span metric is left out of the line, and nothing is added to it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import generator, program, weights
from .harness import DEVICE_CATS, GAPS_NAMED, HOST_CATS, Context, Record, _top, _union, sync

NO_SPAN = "no program span"
LAUNCHING = ("request.launch", "train.step", "train.refresh")
DEVICE = "device:"


def _profiling():
    from xsdeepfwfm_deprecated_torch.utils import profiling
    return profiling if hasattr(profiling, "tracing") and hasattr(profiling, "spans") else None


def stretch(rec: Record, ctx: Context) -> Optional[List]:
    """The spans of the traced stretch's part without the profiler (made on
    the first call), or None where the program has no tracing."""
    if not hasattr(rec, "program_spans"):
        rec.program_spans = _run(rec, ctx) if _profiling() is not None else None
    return rec.program_spans


def mean_ms(rec: Record, ctx: Context, name: str) -> Optional[float]:
    """The mean of span ``name`` in the traced stretch: a device span's
    duration, a host span's self time (its time less its children's, such
    as the tracer's own ``trace.read``)."""
    spans = stretch(rec, ctx)
    if not spans:
        return None
    if name.startswith(DEVICE):
        ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == name]
    else:
        ms = _profiling().self_ms(spans, name)
    return float(np.mean(ms)) if ms else None


def self_ms_total(spans: Sequence, names: Sequence[str]) -> float:
    """The summed self time of every span named in ``names``, in ms."""
    return sum(sum(_profiling().self_ms(spans, n)) for n in names)


def _run(rec: Record, ctx: Context) -> Optional[List]:
    """The spans of the cell's traced stretch without the profiler, with
    what the stretch adds to the record."""
    profiling = _profiling()
    run = {"train_per_batch": _train, "serve_closed_loop": _serve}.get(ctx.traffic["loop"])
    if run is None:
        return None
    with profiling.tracing():
        events, base_ns, profiled, spans = run(rec, ctx, profiling)
        offset_ns = profiling.trace_clock_ns(0)
    gaps, named = gaps_by_span(events, profiled, offset_ns, base_ns)
    if rec.breakdown is not None:
        rec.breakdown["idle_gaps_by_span"] = gaps
    rec.info["idle_named_by_span"] = named
    rec.info["graph_launches_in_spans"] = launches_in_spans(events, profiled, offset_ns, base_ns)
    rec.info["graph_captures_in_window"] = _captures_in_window(rec, ctx)
    rec.info["program_spans"] = _summary(spans, profiling)
    rec.info["profiled_spans"] = _summary(profiled, profiling)
    units = sum(s.name in ("request", "train.step") for s in profiled) or 1
    calls: Dict[str, float] = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
            calls[e["name"]] = calls.get(e["name"], 0.0) + float(e["dur"]) * 1e-3 / units
    rec.info["runtime_calls_ms"] = dict(sorted(calls.items(), key=lambda kv: -kv[1])[:5])
    return spans


def _summary(spans: Sequence, profiling) -> Dict[str, List[float]]:
    """Each span name's count, mean ms and mean self ms."""
    return {n: [sum(s.name == n for s in spans),
                float(np.mean([(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == n])),
                float(np.mean(profiling.self_ms(spans, n)))]
            for n in sorted({s.name for s in spans})}


def _serve(rec: Record, ctx: Context, profiling) -> Tuple[List[Dict], int, List, List]:
    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor

    from .loops.serve_closed_loop import WARM
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b, pool = tr["batch"], tr["pool_requests"]
    int8 = tr["precision"] == "int8-dynamic"
    mcfg = program.model_config(cfg)
    params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    pred = Predictor(convert(params, mcfg, "dynamic") if int8 else params,
                     None if int8 else mcfg, device=dev)
    del params
    xi, xv, _ = generator.sample_rows(cfg, tr, b * pool, ctx.seed, dev)
    xi, xv = xi.reshape(pool, b, -1), xv.reshape(pool, b, -1)
    for k in range(WARM):       # the first captures the traced variant
        pred.logits(xi[k % pool], xv[k % pool])
    sync(dev)
    profiling.spans()
    units = max(50, min(500, 1_000_000 // b))     # as the loop's profiled stretch

    def requests():
        for j in range(units):
            pred.logits(xi[j % pool], xv[j % pool])
    requests()
    spans = profiling.spans()
    events, base_ns = _traced(requests, dev)
    return events, base_ns, profiling.spans(), spans


def _train(rec: Record, ctx: Context, profiling) -> Tuple[List[Dict], int, List, List]:
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.train.trainer import (PruneRefresh, make_optimizer,
                                                            make_train_step)

    from .loops.train_per_batch import PROFILED_STEPS, _endless
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    mcfg, tcfg = program.model_config(cfg), program.train_config(cfg, tr)
    params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    refresh = None
    if tr["prune"]:     # as the loop builds it
        refresh = PruneRefresh(dict(
            emb_r=tcfg.emb_r, emb_corr=tcfg.emb_corr, prune_fm=tcfg.prune_fm and mcfg.needs_emb2,
            prune_deep=tcfg.prune_deep, prune_r=tcfg.prune_r and mcfg.use_fwfm,
            structured_deep=tcfg.prune_deep_structured))
    gen = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
    xi, xv, y = generator.sample_rows(cfg, tr, tr["pool_rows"], ctx.seed, dev)
    feed = batching.prefetch_to_device(_endless(xi, xv, y, tr["batch"]), dev)
    n0 = rec.attempted + PROFILED_STEPS     # where the loop's profiled stretch left the schedule
    step(params, opt_state, next(feed), gen)        # the traced variants' captures
    if refresh is not None:
        refresh(params, tcfg.adaptive_sparse(n0))
    sync(dev)
    profiling.spans()

    def one(i):
        step(params, opt_state, next(feed), gen)
        if refresh is not None and i % tcfg.prune_interval == 0:
            refresh(params, tcfg.adaptive_sparse(n0 + i))

    for i in range(1, PROFILED_STEPS + 1):
        one(i)
        sync(dev)
    spans = profiling.spans()

    def steps():
        for i in range(PROFILED_STEPS + 1, 2 * PROFILED_STEPS + 1):
            one(i)
    events, base_ns = _traced(steps, dev)
    return events, base_ns, profiling.spans(), spans


def _traced(fn, device: torch.device) -> Tuple[List[Dict], int]:
    """The chrome trace's events of ``fn`` under ``torch.profiler`` as
    ``harness.profile`` runs it (the card's activity alone), and the trace's
    ``baseTimeNanoseconds``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    sync(device)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def _host_spans(spans: Sequence, offset_ns: int, base_ns: int) -> Tuple[List, np.ndarray]:
    """The host spans and their (start, end) on the trace's clock, in µs."""
    host = [s for s in spans if not s.name.startswith(DEVICE)]
    at = np.array([[(s.start_ns + offset_ns - base_ns) * 1e-3,
                    (s.end_ns + offset_ns - base_ns) * 1e-3] for s in host],
                  dtype=np.float64).reshape(-1, 2)
    return host, at


def gaps_by_span(events: List[Dict], spans: Sequence, offset_ns: int,
                 base_ns: int) -> Tuple[List[List], Optional[float]]:
    """(the idle gaps by program span, the share of idle time a span names).
    The gaps are ``harness.reduce_trace``'s for a trace of the card alone:
    the union of the device's operations between the first and the last
    runtime call or operation; the ``GAPS_NAMED`` longest are named, by the
    innermost program host span open over the gap's midpoint (perf_counter ns
    plus ``offset_ns`` is Unix ns; an event's ``ts`` is µs after
    ``base_ns``)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    calls = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
    if not dev:
        return [], None
    w0 = min(float(e["ts"]) for e in dev + calls)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev + calls)
    busy = _union(np.array([[max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)]
                            for e in dev], dtype=np.float64).reshape(-1, 2))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])]          # longest first
    host, at = _host_spans(spans, offset_ns, base_ns)
    by_span: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        name = "shorter gaps"
        if i < GAPS_NAMED:
            mid = 0.5 * (a + b)
            over = np.flatnonzero((at[:, 0] <= mid) & (at[:, 1] >= mid))
            name = (host[over[np.argmin(at[over, 1] - at[over, 0])]].name
                    if len(over) else NO_SPAN)
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-6
    idle = sum(by_span.values())
    named = 1.0 - by_span.get(NO_SPAN, 0.0) / idle if idle else None
    return _top(by_span), named


def launches_in_spans(events: List[Dict], spans: Sequence, offset_ns: int,
                      base_ns: int) -> Optional[float]:
    """The share of the trace's ``cudaGraphLaunch`` calls whose middle lies
    inside a span that launches a graph (:data:`LAUNCHING`): how well the
    program's clock and the trace's agree."""
    launches = [float(e["ts"]) + 0.5 * float(e["dur"]) for e in events
                if e.get("name") == "cudaGraphLaunch" and e.get("ph") == "X"]
    if not launches:
        return None
    host, at = _host_spans([s for s in spans if s.name in LAUNCHING], offset_ns, base_ns)
    inside = [bool(np.any((at[:, 0] <= t) & (at[:, 1] >= t))) for t in launches]
    return float(np.mean(inside))


def _captures_in_window(rec: Record, ctx: Context) -> Optional[int]:
    """The program's graph captures between the window's start and end."""
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph
    if not hasattr(cuda_graph, "CAPTURES"):
        return None
    t0 = (ctx.started + rec.setup_s) * 1e9
    return sum(t0 <= at <= t0 + rec.window_s * 1e9 for _, at in cuda_graph.CAPTURES)
