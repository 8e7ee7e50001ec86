"""Training as ``DeepFMEstimator.fit`` runs it at ``steps_per_call`` K > 1 with
pruning: each call is one ``make_multi_step`` group of K steps and the prune
refresh after them (K = ``prune_interval``), one CUDA graph replay on the card.

The pool of host rows is walked as epochs, as ``fit`` walks its training set:
``data.batching.iter_batches`` over the pool in the order it was drawn, then
``data.batching.stack_groups`` into groups of K batches, so an epoch of
``pool_rows / batch`` batches ends in a group of fewer real batches, padded to
K, which is a graph of its own (its padded steps skipped); each group through
``data.batching.prefetch_to_device``. The schedule value of a group's refresh
is ``adaptive_sparse(n)``, ``n`` the real steps stepped so far, as ``fit``
counts them past its warm-up.

Set-up makes the weights and the pool and steps the whole first epoch, which
captures its graphs (the full group and the padded one); its first group is
checked against the reference (``reference/train.py``): the K losses, each
leaf's change over the group and its refresh, and, of every pruned group, the
share of values whose pruning (zero or not) differs from the reference's.
Before it, a group of one real step (as an epoch whose last group holds one
batch runs it: a graph of its own) steps the first batch on a second copy of
the weights and state, with dropout draws of its own; its Adam first moment
holds the first gradient, which is held to the reference's by the worst leaf.
The first moment after ten steps would not do: ten Adam steps turn roundings
into moments that differ by as much as the control's in a small leaf. The
window then walks on for ``--seconds`` and ends in a sync; its losses (the real
steps' alone) are read once, at its end.

With ``--trace 1`` the window carries CUDA events around each call and the
card's wait for the feed between calls; a profiled stretch of
``PROFILED_GROUPS`` calls follows, then the loop's own traced stretch
(``train_xdeepfm.traced_stretch``, its calls each a group). Every count of the
record (``attempted``, ``examples``, the profiled stretch's units) is of steps;
``info traced_stretch_steps`` holds the steps of the traced stretch's calls
that the span metrics read, and ``info window_busy_pct`` the calls' device
time (their events) over the window's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch.data import batching
from xsdeepfwfm_deprecated_torch.train.trainer import make_multi_step, make_optimizer

from .. import compare, generator, program, weights
from ..harness import Context, DeviceTimer, Record, profile, sync
from ..reference import train as ref_train
from .train_per_batch import ADAM_B1
from .train_xdeepfm import PROFILED_STEPS, traced_stretch

PROFILED_GROUPS = 10


def _epochs(xi: np.ndarray, xv: np.ndarray, y: np.ndarray, batch: int, k: int) -> Iterator[Dict]:
    while True:
        yield from batching.stack_groups(batching.iter_batches(xi, xv, y, batch), k)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {key: float(v.double().norm()) for key, v in tensors.items()}


def mask_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """By the worst pruned group: the share of its values that one side pruned
    (zero) and the other did not."""
    return max(float(((prog[k].to(want[k].device) == 0) != (want[k] == 0)).sum())
               / want[k].numel() for k in want)


def reference(cfg: Dict, w0: Dict[str, torch.Tensor], batches: List[Dict], gen, target: float,
              precision: str) -> Dict:
    """The reference's K steps and refresh from ``w0``: the losses, each leaf's
    first gradient (with L2) and change, and the pruned groups after the refresh."""
    ref_train.model.no_tf32()
    w = {k: v.clone() for k, v in w0.items()}
    state: Dict = {}
    losses, first = [], None
    for batch in batches:
        loss, g = ref_train.grads(w, cfg, batch, gen, precision)
        g = {k: g[k] + cfg["weight_decay"] * w[k] for k in w}
        first = first or _norms(g)
        ref_train.adam_(w, g, state, cfg["learning_rate"])
        losses.append(loss)
    w = ref_train.refresh(w, cfg, target)
    return {"losses": losses, "grad": first, "change": _norms({k: w[k] - w0[k] for k in w}),
            "pruned": {k: w[k] for k in ref_train.pruned_names(cfg)}}


def checks(prog: Dict, want: Dict) -> Dict[str, float]:
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])),
            "grad_gap": compare.norm_gap(prog["grad"], want["grad"], compare.counted(want["grad"])),
            "median_change_gap": float(np.median(list(compare.leaf_gaps(
                prog["change"], want["change"], want["change"]).values()))),
            "mask_gap": mask_gap(prog["pruned"], want["pruned"])}


def run(ctx: Context) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    mcfg, tcfg = program.model_config(cfg), program.train_config(cfg, tr)
    b, k = tr["batch"], tr["steps_per_call"]
    if not tr["prune"] or k != tcfg.prune_interval or tr["pool_rows"] % b:
        raise ValueError("train_multi_step drives K = prune_interval steps and a refresh a call "
                         "over whole batches")
    rec = Record()
    params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    multi = make_multi_step(mcfg, tcfg, optimizer, prune_kw=dict(   # as fit builds it
        emb_r=tcfg.emb_r, emb_corr=tcfg.emb_corr, prune_fm=tcfg.prune_fm and mcfg.needs_emb2,
        prune_deep=tcfg.prune_deep, prune_r=tcfg.prune_r and mcfg.use_fwfm,
        structured_deep=tcfg.prune_deep_structured))
    ctx.stage("weights")
    gen = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
    xi, xv, y = generator.sample_rows(cfg, tr, tr["pool_rows"], ctx.seed, dev)
    feed = batching.prefetch_to_device(_epochs(xi, xv, y, b, k), dev)
    groups = -(-tr["pool_rows"] // (b * k))         # calls an epoch, the padded one last
    ctx.stage("pool")
    n = 0

    def call(group) -> torch.Tensor:
        nonlocal n
        n += group["k_real"]
        return multi(params, opt_state, group["xi"], group["xv"], group["y"], group["mask"],
                     gen, None, tcfg.adaptive_sparse(n), k_real=group["k_real"])[:group["k_real"]]

    # the first group, through the window's own call and feed; then the rest of the epoch
    names = ref_train.pruned_names(cfg)
    leaves = program.named(params)
    p0 = {key: v.clone() for key, v in leaves.items()}
    group = next(feed)
    one_params = program.params(mcfg, weights.make(cfg, ctx.seed, dev))
    one_state = optimizer.init(one_params)
    multi(one_params, one_state, group["xi"], group["xv"], group["y"], group["mask"],
          generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev), None,
          tcfg.adaptive_sparse(1), k_real=1)
    grad = _norms({name.split("/mu/", 1)[1]: m / (1 - ADAM_B1)     # (1 - b1) g after a step
                   for name, m in program.named(one_state).items() if "/mu/" in name})
    del one_params, one_state
    first = call(group)
    prog = {"losses": [float(l) for l in first], "grad": grad,
            "change": _norms({key: v - p0[key] for key, v in leaves.items()}),
            "pruned": {key: leaves[key].detach().to("cpu", copy=True) for key in names}}
    n_check = n
    del p0
    for _ in range(groups - 1):
        call(next(feed))
    sync(dev)
    ctx.stage("first_epoch")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = time.perf_counter() - ctx.started

    losses: List[torch.Tensor] = []
    timed = dev if ctx.trace else torch.device("cpu")      # events in a traced window alone
    calls_t, feed_t = DeviceTimer(timed), DeviceTimer(timed)
    end = None
    n0 = n
    t0 = time.perf_counter()
    while True:
        group = next(feed)
        e = calls_t.start()
        if end is not None:
            feed_t.pairs.append((end, e))
        losses.append(call(group))
        end = calls_t.stop(e)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    rec.window_s = time.perf_counter() - t0
    window_losses = torch.cat(losses)
    rec.attempted = n - n0
    rec.examples = rec.attempted * b
    rec.failed = int((~torch.isfinite(window_losses)).sum())
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if ctx.trace:
        rec.device_ms["multi_step"] = calls_t.ms()
        rec.device_ms["feed_wait"] = feed_t.ms()
        rec.info["window_busy_pct"] = 100.0 * sum(rec.device_ms["multi_step"]) / (
            1e3 * rec.window_s)

        def one():
            call(next(feed))

        def stretch():
            for _ in range(PROFILED_GROUPS):
                one()
        before = n
        profile(stretch, 0, dev, rec)
        rec.traced_units = n - before       # the stretch's steps
        steps: List[int] = []               # each traced call's: its capture, the spans' part, ...
        rec.program_spans = traced_stretch(
            rec, ctx, lambda: steps.append(int(call(next(feed)).shape[0])))
        rec.info["traced_stretch_steps"] = sum(steps[1:1 + PROFILED_STEPS])
    del multi, params, opt_state, optimizer, feed, losses, window_losses, leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same weights, rows and dropout draws, through the first group
    w0 = weights.make(cfg, ctx.seed, dev)
    batches = [{"xi": torch.from_numpy(xi[i * b:(i + 1) * b]).to(dev),
                "xv": torch.from_numpy(xv[i * b:(i + 1) * b]).to(dev),
                "y": torch.from_numpy(y[i * b:(i + 1) * b]).to(dev)} for i in range(k)]
    target = ref_train.schedule(cfg, n_check)

    def follow(precision: str) -> Dict:
        dropout = generator.torch_generator(ctx.seed, generator.STREAM_DROPOUT, dev)
        return reference(cfg, w0, batches, dropout, target, precision)
    want = follow("fp32")
    rec.checks = checks(prog, want)
    rec.info["worst_grad_gap"] = compare.worst_leaf(prog["grad"], want["grad"],
                                                    compare.counted(want["grad"]))
    rec.info["worst_change_gap"] = compare.worst_leaf(prog["change"], want["change"],
                                                      want["change"])
    rec.info["refresh_check_target"] = target
    rec.info["calls_a_epoch"] = groups
    if ctx.control:
        rec.control_checks = checks(follow("tf32"), want)
    rec.info["first_losses"] = prog["losses"]
    rec.info["setup_stages"] = ctx.stages
    return rec
