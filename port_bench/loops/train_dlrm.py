"""DLRM-DCNv2's training as ``DLRMEstimator.fit`` runs it at its default
``steps_per_call=1``, through the model's door, weights and multi-hot rows
(``port_bench/dlrm.py``).

Batches come from ``data.batching.iter_batches`` over a pool of host rows,
wrapped at its end (the pool holds whole batches), through
``data.batching.prefetch_to_device``; each batch is one ``make_train_step``
call (a CUDA graph replay on the card), whose optimizer steps Adagrad on the
batch's distinct table rows alone. Set-up makes the weights and the pool,
builds the step and drives it through the window's first three steps (the
capture comes with the first), which the reference
(``reference/dlrm_dcnv2.py``) follows on the same weights and rows: on a
compact table of the rows those batches touch, since the full table does not
fit twice. The program's first gradient is read from Adagrad's accumulator
after one step (its square root is |g|), each leaf's change over the three
steps from the rows they touch, and the program's count of rows updated is
held to the distinct rows of the three batches, which the benchmark counts
itself. The window runs for ``--seconds`` and ends in a sync; the losses are
read once, at its end.

With ``--trace 1`` the window carries CUDA events, a profiled stretch of
``PROFILED_STEPS`` steps follows, then the loop's own traced stretch
(``train_xdeepfm.traced_stretch``); the mean distinct rows of the profiled
stretch's batches go into ``info bag_distinct_rows`` for the bags' rooflines.
Memory: ``memory_peak_bytes`` is the window's (reset after set-up); the
card's whole use, graph pools included, is in ``info memory``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step

from .. import compare, dlrm, program
from ..harness import Context, DeviceTimer, Record, profile, sync
from ..reference import dlrm_dcnv2 as ref
from .train_per_batch import CHECK_STEPS, PROFILED_STEPS, _endless
from .train_xdeepfm import traced_stretch

SLOTS = "/sum_of_squares/"
CHUNK = 1 << 26


def _sum_sq(t: torch.Tensor, square: bool = True) -> float:
    """Σ t² (or Σ t, with ``square`` False) in float64, a chunk at a time: a
    float64 copy of the table would not fit beside it."""
    flat = t.detach().reshape(-1)
    total = 0.0
    for part in torch.split(flat, CHUNK):
        part = part.double()
        total += float((part * part).sum() if square else part.sum())
    return total


def _grad_norms(opt_state) -> Dict[str, float]:
    """Each leaf's first gradient's norm, read from Adagrad's accumulator
    after one step, which holds g²."""
    return {name.split(SLOTS, 1)[1]: _sum_sq(acc, square=False) ** 0.5
            for name, acc in program.named(opt_state).items() if SLOTS in name}


def _rows_updated() -> int:
    from xsdeepfwfm_deprecated_torch.utils import profiling
    return int(profiling.counters().get("on_card", {}).get("bag_rows_updated", 0))


def run(ctx: Context) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b = tr["batch"]
    if tr["steps_per_call"] != 1 or tr["prune"] or tr["pool_rows"] % b:
        raise ValueError("train_dlrm drives steps_per_call=1 without a refresh, over whole batches")
    mcfg, tcfg = dlrm.model_config(cfg), dlrm.train_config(cfg, tr)
    rec = Record()
    params = dlrm.params(mcfg, dlrm.make(cfg, ctx.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    ctx.stage("weights")
    xi, xv, y = dlrm.sample_rows(cfg, tr, tr["pool_rows"], ctx.seed, dev)
    feed = batching.prefetch_to_device(_endless(xi, xv, y, b), dev)
    n_batches = tr["pool_rows"] // b
    if dev.type == "cuda":      # the sampler's temporaries: no part of what the step holds
        torch.cuda.empty_cache()
    ctx.stage("pool")

    def rows_of(i: int) -> torch.Tensor:          # the benchmark's own packing of batch i
        return ref.packed_rows(cfg, torch.from_numpy(xi[i * b:(i + 1) * b]).to(dev))

    # the first steps, through the window's own call and feed
    checked = [rows_of(i) for i in range(CHECK_STEPS)]
    distinct = sum(int(torch.unique(r).numel()) for r in checked)
    touched = torch.unique(torch.cat([r.reshape(-1) for r in checked]))
    leaves = program.named(params)
    p0 = {k: (v[touched] if k == ref.TABLE else v).clone() for k, v in leaves.items()}
    updated = _rows_updated()
    first_losses, grad = [], None
    for i in range(CHECK_STEPS):
        first_losses.append(step(params, opt_state, next(feed)))
        if i == 0:
            grad = _grad_norms(opt_state)
    change = {k: _sum_sq((v[touched] if k == ref.TABLE else v) - p0[k]) ** 0.5
              for k, v in leaves.items()}
    prog = {"losses": [float(l) for l in first_losses], "grad": grad, "change": change}
    updated = _rows_updated() - updated
    del p0
    sync(dev)
    ctx.stage("first_steps")
    memory = {}
    if dev.type == "cuda":
        memory["setup_peak_allocated"] = int(torch.cuda.max_memory_allocated(dev))
        memory["setup_peak_reserved"] = int(torch.cuda.max_memory_reserved(dev))
        torch.cuda.empty_cache()    # the check's copies: the window's card holds the step alone
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
            losses.append(step(params, opt_state, batch))
            end = steps_t.stop(e)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    else:
        while True:
            losses.append(step(params, opt_state, next(feed)))
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
        free, total = torch.cuda.mem_get_info(dev)
        memory.update(window_peak_reserved=int(torch.cuda.max_memory_reserved(dev)),
                      card_used=int(total - free))
    if ctx.trace:
        rec.device_ms["train_step"] = steps_t.ms()
        rec.device_ms["feed_wait"] = feed_t.ms()

        def one():
            step(params, opt_state, next(feed))

        def stretch():
            for _ in range(PROFILED_STEPS):
                one()
        first = CHECK_STEPS + n            # the pool batch the profiled stretch starts at
        profile(stretch, PROFILED_STEPS, dev, rec)
        stretch_batches = {(first + i) % n_batches for i in range(PROFILED_STEPS)}
        per_batch = {i: int(torch.unique(rows_of(i)).numel()) for i in stretch_batches}
        rec.info["bag_distinct_rows"] = float(np.mean(
            [per_batch[(first + i) % n_batches] for i in range(PROFILED_STEPS)]))
        rec.program_spans = traced_stretch(rec, ctx, one)
        if dev.type == "cuda":
            free, total = torch.cuda.mem_get_info(dev)
            memory["card_used_traced"] = int(total - free)
    rec.info["memory"] = memory
    del step, params, opt_state, optimizer, feed, losses, window_losses, leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same weights and rows, on the rows the checked batches touch
    full = dlrm.make(cfg, ctx.seed, dev)
    batches = [{"rows": checked[i], "xv": torch.from_numpy(xv[i * b:(i + 1) * b]).to(dev),
                "y": torch.from_numpy(y[i * b:(i + 1) * b]).to(dev)} for i in range(CHECK_STEPS)]
    w0, batches, _ = ref.compact(full, batches)
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.steps(w0, cfg, batches, "fp32")
    rec.checks = compare.train(prog, want)
    rec.checks["rows_gap"] = abs(updated - distinct) / distinct
    keep = compare.counted(want["grad"])
    rec.info["worst_grad_gap"] = compare.worst_leaf(prog["grad"], want["grad"], keep)
    rec.info["worst_change_gap"] = compare.worst_leaf(prog["change"], want["change"], keep)
    rec.info["rows_updated"] = [updated, distinct]
    if ctx.control:
        control = ref.steps(w0, cfg, batches, "tf32")
        rec.control_checks = {**compare.train(control, want), "rows_gap": 0.0}
    rec.info["first_losses"] = prog["losses"]
    rec.info["setup_stages"] = ctx.stages
    return rec
