"""xDeepFM's training as ``DeepFMEstimator.fit`` runs it at its default
``steps_per_call=1``: ``train_per_batch``'s loop without the prune refresh,
through xDeepFM's door and weights (``port_bench/xdeepfm.py``).

Batches come from ``data.batching.iter_batches`` over a pool of host rows,
wrapped at its end, through ``data.batching.prefetch_to_device``; each batch
is one ``make_train_step`` call (a CUDA graph replay on the card). Set-up makes
the weights and the pool, builds the step and drives it through the window's
first three steps (the capture comes with the first), which the reference
(``reference/xdeepfm.py``) follows on the same weights, rows and dropout
draws. The window runs for ``--seconds`` and ends in a sync; the losses are
read once, at its end.

With ``--trace 1`` the window carries CUDA events (each step, and the card's
wait for the feed between steps), a profiled stretch of ``PROFILED_STEPS``
steps follows it, and then the loop's own traced stretch with the program's
tracing on, as ``program_spans.py`` makes one for the other training cells:
the traced variant's capture, ``PROFILED_STEPS`` steps each followed by a sync
(the spans the metrics read, kept as ``rec.program_spans``), and as many under
``torch.profiler``, whose idle gaps the program's spans name.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step

from .. import compare, generator, program, program_spans, xdeepfm
from ..harness import Context, DeviceTimer, Record, profile, sync
from ..reference import xdeepfm as ref_xdeepfm
from .train_per_batch import ADAM_B1, CHECK_STEPS, PROFILED_STEPS, _endless, _norms


def run(ctx: Context) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if tr["steps_per_call"] != 1 or tr["prune"]:
        raise ValueError("train_xdeepfm drives steps_per_call=1 without a refresh")
    mcfg, tcfg = xdeepfm.model_config(cfg), xdeepfm.train_config(cfg, tr)
    rec = Record()
    b = tr["batch"]
    params = program.params(mcfg, xdeepfm.make(cfg, ctx.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    ctx.stage("weights")
    gen = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
    xi, xv, y = generator.sample_rows(cfg, tr, tr["pool_rows"], ctx.seed, dev)
    feed = batching.prefetch_to_device(_endless(xi, xv, y, b), dev)
    ctx.stage("pool")

    # the first steps, through the window's own call and feed
    leaves = program.named(params)
    p0 = {k: v.clone() for k, v in leaves.items()}
    first_losses, grad = [], None
    for i in range(CHECK_STEPS):
        first_losses.append(step(params, opt_state, next(feed), gen))
        if i == 0:      # the optimizer's first moment after one step holds (1 - b1) g
            grad = _norms({name.split("/mu/", 1)[1]: m / (1 - ADAM_B1)
                           for name, m in program.named(opt_state).items() if "/mu/" in name})
    prog = {"losses": [float(l) for l in first_losses], "grad": grad,
            "change": _norms({k: v - p0[k] for k, v in leaves.items()})}
    del p0
    sync(dev)
    ctx.stage("first_steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = time.perf_counter() - ctx.started

    losses: List[torch.Tensor] = []
    n = 0
    steps_t, feed_t = DeviceTimer(dev), DeviceTimer(dev)
    end = None
    t0 = time.perf_counter()
    if ctx.trace:
        while True:
            batch = next(feed)
            e = steps_t.start()
            if end is not None:
                feed_t.pairs.append((end, e))
            losses.append(step(params, opt_state, batch, gen))
            end = steps_t.stop(e)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    else:
        while True:
            losses.append(step(params, opt_state, next(feed), gen))
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    sync(dev)
    rec.window_s = time.perf_counter() - t0
    window_losses = torch.stack(losses)
    rec.attempted, rec.examples = n, n * b
    rec.failed = int((~torch.isfinite(window_losses)).sum())
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if ctx.trace:
        rec.device_ms["train_step"] = steps_t.ms()
        rec.device_ms["feed_wait"] = feed_t.ms()

        def one():
            step(params, opt_state, next(feed), gen)

        def stretch():
            for _ in range(PROFILED_STEPS):
                one()
        profile(stretch, PROFILED_STEPS, dev, rec)
        rec.program_spans = traced_stretch(rec, ctx, one)
    del step, params, opt_state, optimizer, feed, losses, window_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same weights, rows and dropout draws
    w0 = xdeepfm.make(cfg, ctx.seed, dev)
    batches = [{"xi": torch.from_numpy(xi[i * b:(i + 1) * b]).to(dev),
                "xv": torch.from_numpy(xv[i * b:(i + 1) * b]).to(dev),
                "y": torch.from_numpy(y[i * b:(i + 1) * b]).to(dev)} for i in range(CHECK_STEPS)]

    def reference(precision: str) -> Dict:
        dropout = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
        return ref_xdeepfm.steps(w0, cfg, batches, dropout, precision)
    ref = reference("fp32")
    rec.checks = compare.train(prog, ref)
    keep = compare.counted(ref["grad"])
    rec.info["worst_grad_gap"] = compare.worst_leaf(prog["grad"], ref["grad"], keep)
    rec.info["worst_change_gap"] = compare.worst_leaf(prog["change"], ref["change"], keep)
    if ctx.control:
        rec.control_checks = compare.train(reference("tf32"), ref)
    rec.info["first_losses"] = prog["losses"]
    rec.info["setup_stages"] = ctx.stages
    return rec


def traced_stretch(rec: Record, ctx: Context, one) -> Optional[List]:
    """The spans of ``PROFILED_STEPS`` calls of ``one`` with the program's
    tracing on, each followed by a sync, after the traced variant's capture;
    then as many under ``torch.profiler``, whose idle gaps and graph launches
    the spans name, into the record as ``program_spans._run`` puts them. None
    where the program has no tracing."""
    profiling, dev = program_spans._profiling(), ctx.device
    if profiling is None:
        return None
    with profiling.tracing():
        one()                       # the traced variant's capture
        sync(dev)
        profiling.spans()
        for _ in range(PROFILED_STEPS):
            one()
            sync(dev)
        spans = profiling.spans()

        def steps():
            for _ in range(PROFILED_STEPS):
                one()
        events, base_ns = program_spans._traced(steps, dev)
        profiled = profiling.spans()
        offset_ns = profiling.trace_clock_ns(0)
    gaps, named = program_spans.gaps_by_span(events, profiled, offset_ns, base_ns)
    if rec.breakdown is not None:
        rec.breakdown["idle_gaps_by_span"] = gaps
    rec.info["idle_named_by_span"] = named
    rec.info["graph_launches_in_spans"] = program_spans.launches_in_spans(events, profiled,
                                                                          offset_ns, base_ns)
    rec.info["graph_captures_in_window"] = program_spans._captures_in_window(rec, ctx)
    rec.info["program_spans"] = program_spans._summary(spans, profiling)
    rec.info["profiled_spans"] = program_spans._summary(profiled, profiling)
    return spans
