"""Training as ``DeepFMEstimator.fit`` runs it at its default ``steps_per_call=1``.

Batches come from the program's ``data.batching.iter_batches`` over a pool of
host rows, walked in the order they were drawn and wrapped at its end, through
``data.batching.prefetch_to_device``; each batch is one ``make_train_step``
call (a CUDA graph replay on the card), and with ``prune`` one
``PruneRefresh`` call follows every ``prune_interval``-th step at the
schedule value ``adaptive_sparse(n)``, ``n`` the steps since the window
began. The losses stay on the card and are read once, at the window's end,
as ``fit`` reads them at an epoch's end.

Set-up makes the weights and the pool, builds the step and drives it through
the window's first three steps (the capture comes with the first), which the
reference follows; a refresh at schedule value 0 captures the refresh and
prunes nothing. The window then runs for ``--seconds`` and ends in a sync.
With ``--trace 1`` the same window carries CUDA events, and a profiled
stretch of ``PROFILED_STEPS`` steps follows it. The events time each step and
refresh, and the device's wait for the feed: from the end of one step's work
(its refresh included) to the start of the next step, which holds the next
batch's copy and any time the card waited for the host to hand that batch
over.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Iterator

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.train.trainer import (PruneRefresh, make_optimizer,
                                                        make_train_step)

from .. import compare, generator, program, weights
from ..harness import Context, DeviceTimer, Record, profile, sync
from ..reference import train as ref_train

CHECK_STEPS = 3
PROFILED_STEPS = 100
ADAM_B1 = 0.9


def _endless(xi: np.ndarray, xv: np.ndarray, y: np.ndarray, batch: int) -> Iterator[Dict]:
    while True:
        yield from batching.iter_batches(xi, xv, y, batch)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def run(ctx: Context) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if tr["steps_per_call"] != 1:
        raise ValueError("train_per_batch drives steps_per_call=1")
    rec = Record()
    mcfg, tcfg = program.model_config(cfg), program.train_config(cfg, tr)
    b, prune = tr["batch"], bool(tr["prune"])
    params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    refresh = None
    if prune:   # as fit builds its keyword arguments
        refresh = PruneRefresh(dict(
            emb_r=tcfg.emb_r, emb_corr=tcfg.emb_corr, prune_fm=tcfg.prune_fm and mcfg.needs_emb2,
            prune_deep=tcfg.prune_deep, prune_r=tcfg.prune_r and mcfg.use_fwfm,
            structured_deep=tcfg.prune_deep_structured))
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
    if refresh is not None:
        refresh(params, tcfg.adaptive_sparse(0))
    sync(dev)
    ctx.stage("first_steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = time.perf_counter() - ctx.started

    interval = tcfg.prune_interval
    losses = []
    n = 0
    steps_t, refresh_t, feed_t = DeviceTimer(dev), DeviceTimer(dev), DeviceTimer(dev)
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
            if refresh is not None and n % interval == 0:
                e = refresh_t.start()
                refresh(params, tcfg.adaptive_sparse(n))
                end = refresh_t.stop(e)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    else:
        while True:
            losses.append(step(params, opt_state, next(feed), gen))
            n += 1
            if refresh is not None and n % interval == 0:
                refresh(params, tcfg.adaptive_sparse(n))
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
        if refresh_t.pairs:
            rec.device_ms["prune_refresh"] = refresh_t.ms()

        def stretch():
            for i in range(1, PROFILED_STEPS + 1):
                step(params, opt_state, next(feed), gen)
                if refresh is not None and i % interval == 0:
                    refresh(params, tcfg.adaptive_sparse(n + i))
        profile(stretch, PROFILED_STEPS, dev, rec)
        n += PROFILED_STEPS

    # the window's own refresh, once more, from the state the window left
    if refresh is not None:
        n_check = (n // interval + 1) * interval
        names = ref_train.pruned_names(cfg)
        before = {k: program.named(params)[k].detach().to("cpu", copy=True) for k in names}
        refresh(params, tcfg.adaptive_sparse(n_check))
        after = {k: program.named(params)[k].detach().to("cpu", copy=True) for k in names}
    del step, refresh, params, opt_state, optimizer, feed, losses, window_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same weights, rows and dropout draws
    w0 = weights.make(cfg, ctx.seed, dev)
    batches = [{"xi": torch.from_numpy(xi[i * b:(i + 1) * b]).to(dev),
                "xv": torch.from_numpy(xv[i * b:(i + 1) * b]).to(dev),
                "y": torch.from_numpy(y[i * b:(i + 1) * b]).to(dev)} for i in range(CHECK_STEPS)]

    def reference(precision: str) -> Dict:
        dropout = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
        return ref_train.steps(w0, cfg, batches, dropout, precision)
    ref = reference("fp32")
    rec.checks = compare.train(prog, ref)
    keep = compare.counted(ref["grad"])
    rec.info["worst_grad_gap"] = compare.worst_leaf(prog["grad"], ref["grad"], keep)
    rec.info["worst_change_gap"] = compare.worst_leaf(prog["change"], ref["change"], keep)
    if prune:
        target = ref_train.schedule(cfg, n_check)
        ref_after = ref_train.refresh({k: t.to(dev) for k, t in before.items()}, cfg, target)
        rec.checks["refresh_gap"] = compare.refresh_gap(after, ref_after, names)
        rec.info["refresh_check_target"] = target
    if ctx.control:
        rec.control_checks = compare.train(reference("tf32"), ref)
    rec.info["first_losses"] = prog["losses"]
    rec.info["setup_stages"] = ctx.stages
    return rec
