#!/usr/bin/env python3
"""Serve and train the full-Criteo DeepFwFM flagship through the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--iters 100]

Phases, each printed on its own line:
  1. device: needs CUDA (exits non-zero without it); prints the card's name and power limit
  2. build: compiles every CUDA source of the port with nvcc into build/kernels/;
     prints registers, spills and how many clusters of the tower kernel the card holds
  3. model: the flagship at full width (1,326,055 packed rows, 39x10 -> 400^3 -> 1),
     seeded random weights and seeded requests
  4. fp32 serving: Predictor answers 3 requests at B=8192, 1 at B=1, 1 at B=1000;
     the B=8192 logits equal the port's CPU forward
  5. int8 serving: the same on the dynamic-int8 model; the fused tower kernel runs on
     the B=8192 requests only, and the logits equal the port's CPU int8 forward
  6. the tower's two kernels (the cluster kernel and the layered route) against the
     plain PyTorch version on the card: the main path's shape, one small cluster,
     and more tiles than the card holds clusters
  7. times (cluster kernel, layered route, plain version, library yardstick, bound), kernels per tower call, the cluster kernel's own
     clock readings, and Predictor examples/s, each beside the card's name and power limit
  8. train: DeepFMEstimator.fit on seeded rows (64 batches of 2,048, labels from a seeded
     logistic model): 3 steps on the card equal the same 3 steps on the CPU (dropout off);
     then one epoch with dropout on: finite losses, the epoch's mean below the first
     step's, and table rows that no batch read changed only by L2
  9. prune: a second epoch resumed from the first's checkpoint with the DeepLight schedule
     (a refresh every 10 steps over the 13.26 M-value table); each group's sparsity follows
     the schedule, and no weight below its group's threshold survives a refresh
 10. checkpoint and serve: save(sparse=True), load into a fresh estimator, identical
     logits; the Predictor serves the trained model in fp32 and int8, the int8 tower
     launching once per 8192-row request and equal to its plain version on these weights
 11. training times: ms per step, examples/s, the step's parts, ms per prune refresh and
     per eval batch, the device's busy share of a step and its largest device operations
 12. one JSON line of per-kernel results
 13. last line: {"ok": true, "device": {...}}
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BATCH = 8192
TRAIN_BATCH = 2048
TRAIN_BATCHES = 64
REQUEST_SIZES = (BATCH, BATCH, BATCH, 1, 1000)
TOL = 1e-4   # fp32: float32 sums in another order; int8: epilogue rounding


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Median of per-call CUDA-event times, after a warm-up and a sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``per_graph`` calls captured into a CUDA graph
    and replayed, so that no host gap between launches is timed. Median over
    the replays of CUDA-event time / per_graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host-clock time of calls that end in a device sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_top(fn, calls: int = 20, top: int = 8):
    """torch.profiler over ``calls`` calls: per call, the host time under the
    profiler, the summed time of device-side events (kernels, copies, memsets;
    host ops that launched them are left out, so nothing counts twice), and
    the device events that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return wall_ms, busy_ms, [(e.key[:60], e.self_device_time_total / 1e3 / calls,
                               e.count / calls) for e in rows]


def seeded_tower(in_dim: int, hidden, seed: int, device):
    """A per-channel int8 tower from seeded weights, packed for the kernels."""
    from xsdeepfwfm_deprecated_torch.ops import quantized as q_ops
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import pack_quantized_deep
    rng = np.random.default_rng(seed)
    dims = [in_dim] + list(hidden)
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        w = torch.from_numpy((rng.normal(size=(fi, fo)) * (2.0 / (fi + fo)) ** 0.5)
                             .astype(np.float32))
        w_q, w_s = q_ops.quantize_symmetric(w, axis=1)
        bias = torch.from_numpy((rng.normal(size=(fo,)) * 0.1).astype(np.float32))
        layers.append({"w_q": w_q, "w_scale": w_s.reshape(-1), "b": bias})
    fc_q, fc_s = q_ops.quantize_symmetric(
        torch.from_numpy((rng.normal(size=(dims[-1], 1)) * 0.2).astype(np.float32)), axis=1)
    layers_q, fc = pack_quantized_deep({"layers": layers,
                                        "fc": {"w_q": fc_q, "w_scale": fc_s.reshape(-1)}})
    return (tuple(tuple(t.to(device) for t in layer) for layer in layers_q),
            tuple(t.to(device) for t in fc))


def tiles_with_different_scales(b: int, k: int, block_b: int, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(b, k)).astype(np.float32)
    for i in range(b // block_b):
        x[i * block_b:(i + 1) * block_b] *= 0.5 + i
    return torch.from_numpy(x)


def make_requests(cfg, seed: int):
    """Seeded requests: categorical indices within each field's cardinality,
    normal numeric values."""
    rng = np.random.default_rng(seed)
    highs = list(cfg.feature_sizes[cfg.numerical:])
    return [(rng.integers(0, highs, size=(b, len(highs))).astype(np.int32),
             rng.normal(size=(b, cfg.numerical)).astype(np.float32)) for b in REQUEST_SIZES]


def make_training_rows(cfg, seed: int, n: int):
    """Seeded training rows at the model's cardinalities. The labels come from
    a seeded logistic model of four numeric and two categorical fields, so
    that there is something to learn."""
    rng = np.random.default_rng(seed)
    highs = list(cfg.feature_sizes[cfg.numerical:])
    xi = rng.integers(0, highs, size=(n, len(highs))).astype(np.int32)
    xv = rng.normal(size=(n, cfg.numerical)).astype(np.float32)
    w = rng.normal(size=4)
    logit = xv[:, :4] @ w + 0.8 * (xi[:, 0] % 2) - 0.6 * (xi[:, 4] % 3) - 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return xi, xv, y


def zero_share(t: torch.Tensor) -> float:
    return 1.0 - float(torch.count_nonzero(t)) / t.numel()


def int_mm_tower(x, layers_kn, fc_kn, fc_scale, block_b):
    """The fused tower's function with its products through torch._int_mm on
    the padded operands: a yardstick timed here, never used by the port."""
    b, width = x.shape[0], layers_kn[0][0].shape[0]
    n_tiles = b // block_b

    def codes(h):
        tiles = h.reshape(n_tiles, block_b, -1)
        amax = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)
        s = amax / torch.full_like(amax, 127.0)
        return s, torch.round(tiles / s).clamp(-127, 127).to(torch.int8).reshape(b, -1)

    h = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    for w_kn, w_scale, bias in layers_kn:
        s, q = codes(h)
        acc = torch._int_mm(q, w_kn).to(torch.float32).reshape(n_tiles, block_b, width)
        h = torch.relu(acc * s * w_scale + bias).reshape(b, width)
    s, q = codes(h)
    acc = torch._int_mm(q, fc_kn)[:, :1].to(torch.float32).reshape(n_tiles, block_b, 1)
    return (acc * s * fc_scale).reshape(b, 1)


def tower_bound(deep_q, b: int, in_bytes: int):
    """Least time of one tower call on the card: each input read once (x and
    the unpadded weights, scales, biases), the output written once, and the
    int8 operations of the unpadded products."""
    net = deep_q["net_1"]
    mats = [l["w_q"] for l in net["layers"]] + [net["fc"]["w_q"]]
    vecs = ([l["w_scale"] for l in net["layers"]] + [l["b"] for l in net["layers"]]
            + [net["fc"]["w_scale"]])
    n_bytes = in_bytes + b * 4 + sum(t.numel() * t.element_size() for t in mats + vecs)
    n_ops = sum(2 * b * m.shape[0] * m.shape[1] for m in mats)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


STEP_TOL = dict(rtol=1e-4, atol=2e-5)   # a parameter after 3 Adam steps, card against CPU
CLOSE_SHARE = 0.99                      # of the model's values must be within STEP_TOL


def lockstep_steps(cfg, tc, rows, seed: int, n_steps: int, trainer, deepfwfm, _tree) -> dict:
    """``n_steps`` train steps on the card, each checked against the CPU from the
    card's own parameters and state, so that no difference is carried from one
    step into the next. The loss within 1e-6; every leaf's gradient within
    1e-2 of the leaf's largest (float32 sums in another order are 1e-6 of it; a
    ReLU whose input rounds to the other side of zero for one example of the
    2,048 moved a bias gradient by 1e-3 of its largest in a run); then the
    optimizer on the same gradients: parameters and state within 1e-5 relative
    (elementwise float32 arithmetic, fused or not), a value below a thousandth
    of its leaf's largest being held to that thousandth."""
    xi, xv, y = rows
    batch_size = tc.batch_size
    params = deepfwfm.init_params(torch.Generator().manual_seed(seed), cfg)
    opt = trainer.make_optimizer(tc)
    state = opt.init(params)
    to_cpu = lambda tree: _tree.tree_map(lambda t: t.detach().cpu().clone(), tree)
    worst = {"loss": 0.0, "grad": 0.0, "update": 0.0}
    for i in range(n_steps):
        rows_i = slice(i * batch_size, (i + 1) * batch_size)
        batch = {"xi": torch.from_numpy(xi[rows_i]), "xv": torch.from_numpy(xv[rows_i]),
                 "y": torch.from_numpy(y[rows_i]), "mask": torch.ones(batch_size)}
        params_c, state_c = to_cpu(params), to_cpu(state)
        loss_c, grads_c = trainer.loss_and_grads(params_c, batch, cfg, tc)
        loss_g, grads_g = trainer.loss_and_grads(
            params, {k: v.to(params["bias"].device) for k, v in batch.items()}, cfg, tc)
        worst["loss"] = max(worst["loss"], abs(float(loss_g) - float(loss_c)))
        check(worst["loss"] <= 1e-6, f"step {i}: loss {float(loss_g)} vs CPU {float(loss_c)}")
        for (name, _), g_g, g_c in zip(_tree.named_leaves(params), grads_g, grads_c):
            scale = float(g_c.abs().max())
            err = float((g_g.cpu() - g_c).abs().max()) / max(scale, 1e-30)
            worst["grad"] = max(worst["grad"], err)
            check(err <= 1e-2, f"step {i}: gradient of {name} differs by {err} of its largest")
        opt.update(params, list(grads_g), state)
        opt.update(params_c, [g.cpu() for g in grads_g], state_c)
        for tree_g, tree_c in ((params, params_c), (state, state_c)):
            for (name, a), (_, b) in zip(_tree.named_leaves(tree_g), _tree.named_leaves(tree_c)):
                a, b = a.cpu().double(), b.double()
                floor = max(1e-3 * float(b.abs().max()), 1e-30)   # a sum that cancels
                err = float(((a - b).abs() / b.abs().clamp(min=floor)).max())
                worst["update"] = max(worst["update"], err)
                check(err <= 1e-5, f"step {i}: {name} after the update differs by {err} relative")
    return worst


def training_phases(args, cfg, card: str) -> dict:
    """Phases 8 to 11: train, prune, checkpoint and serve, times. Returns what
    the kernels line reports of the int8 tower on this path."""
    import dataclasses
    import itertools
    import logging
    import os
    import tempfile

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.compression import pruning
    from xsdeepfwfm_deprecated_torch.compression.quantization import (
        convert, quantized_forward, quantized_lookup_serving)
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.entry import flagship_train_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
    from xsdeepfwfm_deprecated_torch.ops import mlp as mlp_ops
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp, int8_mlp_reference
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.train import metrics, trainer

    quiet = logging.getLogger("chip_smoke.fit")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    where = f"[{card}]"
    spec = deepfwfm.make_embedding_spec(cfg)
    num = cfg.numerical
    xi, xv, y = make_training_rows(cfg, args.seed + 10, TRAIN_BATCH * TRAIN_BATCHES)
    int8_mlp.launches = 0

    # ---- 8. train: three steps on the card against the CPU, dropout off
    plain_cfg = dataclasses.replace(cfg, is_shallow_dropout=False, is_deep_dropout=False)
    head = slice(0, 3 * TRAIN_BATCH)
    tc = flagship_train_config(n_epochs=1, batch_size=TRAIN_BATCH, random_seed=args.seed)
    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = trainer.DeepFMEstimator(plain_cfg, tc, logger=quiet, device=device).fit(
            xi[head], xv[head], y[head])
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(all(t.device.type == "cuda" for t in _tree.leaves(gpu.params)), "fit left the card")
    np.testing.assert_allclose(gpu.last_epoch_losses, cpu.last_epoch_losses, rtol=0, atol=1e-5)
    # Adam's step is lr * g / (|g| + eps) at first, and at this model's start most
    # gradients of the first layer and many of the table are of the order of eps (1e-8):
    # there a difference of 1e-8 in a gradient moves the weight by a good part of lr. So the
    # two runs are held to: the losses; CLOSE_SHARE of all values within STEP_TOL; no value
    # further apart than Adam can move it (3.2 lr a step); the logits of a batch. What a
    # single step computes is held tightly by lockstep_steps
    n_close = n_all = 0
    far = 0.0
    for (name, a), (_, b) in zip(_tree.named_leaves(gpu.params), _tree.named_leaves(cpu.params)):
        diff = (a.cpu() - b).abs()
        far = max(far, float(diff.max()))
        n_close += int((diff <= STEP_TOL["atol"] + STEP_TOL["rtol"] * b.abs()).sum())
        n_all += diff.numel()
    close_share = n_close / n_all
    check(close_share >= CLOSE_SHARE, f"only {close_share} of the values within {STEP_TOL}")
    check(far <= 3 * 3.2 * tc.learning_rate, f"a value is {far} apart after 3 steps")
    tail = slice(3 * TRAIN_BATCH, 3 * TRAIN_BATCH + BATCH)
    logit_gap = float(np.abs(gpu._predict_logits(xi[tail], xv[tail])
                             - cpu._predict_logits(xi[tail], xv[tail])).max())
    check(logit_gap <= 1e-3, f"logits after 3 steps differ by {logit_gap}")
    del runs, gpu, cpu
    lock = lockstep_steps(plain_cfg, tc, (xi, xv, y), args.seed, 3, trainer, deepfwfm, _tree)

    # one epoch with dropout on, through the per-epoch checkpoint
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "flagship")
    est = trainer.DeepFMEstimator(cfg, tc, logger=quiet)
    dev = est.device
    init_table = est.init_params()["emb2"]["dense"].clone()
    t0 = time.perf_counter()
    est.fit(xi, xv, y, save_path=path)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = est.last_epoch_losses
    check(len(losses) == TRAIN_BATCHES and bool(np.isfinite(losses).all()), "losses not finite")
    check(est.last_epoch_mean_loss < losses[0],
          f"the epoch's mean loss {est.last_epoch_mean_loss} is not below the first {losses[0]}")
    check(est._step == TRAIN_BATCHES, f"{est._step} steps")
    # rows that no batch read: Adam saw the gradient wd * w alone. Replay that on the card
    touched = np.zeros(spec.dense_rows, dtype=bool)
    touched[:num] = True
    touched[(xi.astype(np.int64) + np.asarray(spec.dense_offsets[num:])).ravel()] = True
    untouched = torch.from_numpy(~touched).to(dev)
    replay = {"rows": init_table[untouched].clone()}
    opt = trainer.make_optimizer(tc)
    state = opt.init(replay)
    for _ in range(TRAIN_BATCHES):
        opt.update(replay, [torch.zeros_like(replay["rows"])], state)
    table = est.params["emb2"]["dense"]
    l2_err = float((table[untouched] - replay["rows"]).abs().max())
    moved = float((table[untouched] - init_table[untouched]).abs().max())
    check(l2_err <= 1e-6 * float(init_table.abs().max()) and moved > 0,
          f"untouched rows differ from the L2-only replay by {l2_err} (moved {moved})")
    read_moved = float((table[~untouched] - init_table[~untouched]).abs().max())
    check(read_moved > moved, "rows that were read moved no further than the others")
    phase(8, f"train: 3 steps of fit, card vs CPU (dropout off): losses within 1e-5, "
             f"{close_share:.5f} of the values within rtol {STEP_TOL['rtol']} atol "
             f"{STEP_TOL['atol']} (limit {CLOSE_SHARE}), furthest {far:.3e}, logits of {BATCH} "
             f"rows within {logit_gap:.3e}; step by step from the card's own state: loss within "
             f"{lock['loss']:.3e}, gradients within {lock['grad']:.3e} of each leaf's largest, "
             f"parameters and state after the update within {lock['update']:.3e} relative; "
             f"epoch of {TRAIN_BATCHES} x {TRAIN_BATCH} with "
             f"dropout: first loss {losses[0]:.4f}, mean {est.last_epoch_mean_loss:.4f}, last "
             f"{losses[-1]:.4f}, train AUC {est.train_result[-1]:.4f}; {int((~touched).sum())} "
             f"untouched rows follow L2 alone within {l2_err:.3e}; fit took {epoch_s:.2f} s "
             f"(steps, eval of the train rows, checkpoint) {where}")

    # ---- 9. prune: the second epoch, resumed, on the DeepLight schedule
    tc2 = flagship_train_config(n_epochs=2, batch_size=TRAIN_BATCH, prune=True, warm=1,
                                sparse=0.9, random_seed=args.seed)
    est2 = trainer.DeepFMEstimator(cfg, tc2, logger=quiet)
    est2.fit(xi, xv, y, resume_from=path)
    check(est2._step == 2 * TRAIN_BATCHES, f"resumed fit ended at step {est2._step}")
    target = tc2.adaptive_sparse(TRAIN_BATCHES)
    net = est2.params["deep"]["net_1"]
    groups = {"emb2/dense": est2.params["emb2"]["dense"], "fwlw_w": est2.params["fwlw_w"],
              **{f"deep/layers/{i}/w": l["w"] for i, l in enumerate(net["layers"])}}
    shares = {}
    for name, t in groups.items():
        shares[name] = zero_share(t)
        tol = max(1e-3, 1.0 / t.numel())     # or one element, for the 390-value fwlw weight
        check(abs(shares[name] - target) <= tol,
              f"{name}: sparsity {shares[name]} after the last refresh, schedule {target}")
    kept = [est2.params["field_cov"], est2.params["lw_w"], net["fc_w"]] + \
           [l["b"] for l in net["layers"]]
    check(all(zero_share(t) == 0.0 for t in kept), "a tensor outside the groups was pruned")
    check(bool(np.isfinite(est2.last_epoch_losses).all()), "pruned epoch: losses not finite")
    # one refresh by hand at 60%: nothing below a group's threshold survives it
    big = 0.6
    pruned = pruning.prune_params(est2.params, big, prune_fm=True, prune_deep=True, prune_r=True)
    r = est2.params["field_cov"]
    by_hand = [("emb2/dense", est2.params["emb2"]["dense"], pruned["emb2"]["dense"], None),
               ("field_cov", r, pruned["field_cov"], 0.5 * (r + r.T))]
    by_hand += [(f"deep/layers/{i}/w", l["w"], pl["w"], None) for i, (l, pl) in
                enumerate(zip(net["layers"], pruned["deep"]["net_1"]["layers"]))]
    for name, before, after, ranked in by_hand:
        ranked = before if ranked is None else ranked
        thr = pruning.magnitude_threshold(ranked, big)
        below = ranked.abs() < thr
        check(int(torch.count_nonzero(after[below])) == 0, f"{name}: a weight below "
              f"the threshold {float(thr):.3e} survived the refresh")
        check(torch.equal(after[~below], before[~below]), f"{name}: a kept weight changed")
        # field_cov goes in symmetric pairs, so its share moves by two elements at a time
        check(abs(zero_share(after) - big) <= max(1e-3, 2.0 / after.numel()),
              f"{name}: {zero_share(after)} pruned at target {big}")
    phase(9, f"prune: resumed at epoch 2, {TRAIN_BATCHES} steps with a refresh every "
             f"{tc2.prune_interval}; schedule {target:.5f}, sparsity "
             + ", ".join(f"{k} {v:.5f}" for k, v in shares.items())
             + f"; total {est2.epoch_sparsity[-1]:.4f}%; a refresh by hand at {big} leaves "
               f"nothing below its thresholds {where}")

    # ---- 10. checkpoint and serve the trained, pruned model
    est2.params = pruned
    sparse_path = os.path.join(tmp.name, "pruned")
    est2.save(sparse_path, epoch=1, sparse=True)
    with np.load(sparse_path + ".npz") as data:
        check("params::emb2/dense@idx" in data.files, "the pruned table was not stored as COO")
    npz_bytes = os.path.getsize(sparse_path + ".npz")
    fresh = trainer.DeepFMEstimator(cfg, tc2, logger=quiet).load(sparse_path)
    n_req = 2
    rows = slice(0, n_req * BATCH)
    want = est2._predict_logits(xi[rows], xv[rows])
    got = fresh._predict_logits(xi[rows], xv[rows])
    check(np.array_equal(want, got), "the loaded model's logits differ from the saved model's")
    pred = Predictor(fresh.params, cfg)
    qm_cpu = convert(_tree.tree_map(lambda t: t.cpu(), fresh.params), cfg, "dynamic")
    pred_q = Predictor(qm_cpu)
    fp32_err = int8_err = int8_gap = auc_gap = 0.0
    for i in range(n_req):
        req = slice(i * BATCH, (i + 1) * BATCH)
        out = pred.logits(xi[req], xv[req])
        np.testing.assert_allclose(out, want[req], rtol=TOL, atol=TOL)
        fp32_err = max(fp32_err, float(np.abs(out - want[req]).max()))
        before = int8_mlp.launches
        out_q = pred_q.logits(xi[req], xv[req])
        check(int8_mlp.launches == before + 1, "the int8 tower did not launch once a request")
        check(out_q.shape == (BATCH,) and bool(np.isfinite(out_q).all()), "int8 logits")
        on_cpu = quantized_forward(qm_cpu, torch.from_numpy(xi[req]), torch.from_numpy(xv[req]),
                                   use_fused_kernel=True).numpy()
        np.testing.assert_allclose(out_q, on_cpu, rtol=0, atol=TOL)
        int8_err = max(int8_err, float(np.abs(out_q - on_cpu).max()))
        int8_gap = max(int8_gap, float(np.abs(out_q - out).max()))
        auc_gap = max(auc_gap, abs(metrics.roc_auc(y[req], out_q) - metrics.roc_auc(y[req], out)))
    check(auc_gap < 0.01, f"int8 AUC is {auc_gap} from the fp32 AUC on the same rows")
    train_launches = int8_mlp.launches
    check(train_launches == n_req, f"the training path launched the tower {train_launches} times")
    qm = pred_q._model
    with torch.inference_mode():
        x = quantized_lookup_serving(qm.emb2_q, spec, torch.from_numpy(xi[:BATCH]).to(dev),
                                     torch.from_numpy(xv[:BATCH]).to(dev))
        x = x.reshape(BATCH, -1).contiguous()
        layers, fc = qm.fused_tower
        trained_err = float((int8_mlp(x, layers, fc) - int8_mlp_reference(x, layers, fc))
                            .abs().max())
    check(trained_err <= TOL, f"int8_mlp vs plain version on trained weights: {trained_err}")
    phase(10, f"checkpoint and serve: COO checkpoint {npz_bytes} bytes, loaded logits identical; "
              f"Predictor fp32 vs the estimator max |diff| {fp32_err:.3e}; int8 tower launches "
              f"{train_launches} for {n_req} requests of {BATCH}, int8 logits vs the CPU's int8 "
              f"forward max |diff| {int8_err:.3e}, vs the fp32 logits {int8_gap:.3e} (AUC "
              f"within {auc_gap:.2e}); int8_mlp vs plain version on the trained, pruned weights "
              f"{trained_err:.3e} (tol {TOL}) {where}")

    # ---- 11. training times, on the dense model of phase 8
    params, state = est.params, est.opt_state
    n_cycle = 8
    cycle = itertools.cycle(list(batching.prefetch_to_device(
        batching.iter_batches(xi[:n_cycle * TRAIN_BATCH], xv[:n_cycle * TRAIN_BATCH],
                              y[:n_cycle * TRAIN_BATCH], TRAIN_BATCH), dev)))
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def step():
        return trainer.train_step(params, state, next(cycle), cfg, tc, opt, generator=gen)

    step_ev = cuda_ms(step, args.iters)
    n_host = args.iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_host):
        step()
    torch.cuda.synchronize()
    step_host = (time.perf_counter() - t0) * 1e3 / n_host
    one = next(cycle)
    grads = trainer.loss_and_grads(params, one, cfg, tc, generator=gen)[1]
    fb_ms = cuda_ms(lambda: trainer.loss_and_grads(params, one, cfg, tc, generator=gen),
                    args.iters // 2)
    opt_ms = cuda_ms(lambda: opt.update(params, grads, state), args.iters // 2)

    def lookup_fwd_bwd():
        t = params["emb2"]["dense"].detach().requires_grad_(True)
        out = emb_ops.packed_lookup({"dense": t}, spec, one["xi"], one["xv"])
        return torch.autograd.grad(out, t, cot)

    cot = torch.ones((TRAIN_BATCH, cfg.field_size, cfg.embedding_size), device=dev)
    look_ms = cuda_ms(lookup_fwd_bwd, args.iters // 2)
    x_in = torch.randn((TRAIN_BATCH, cfg.field_size, cfg.embedding_size), device=dev,
                       generator=gen)
    rates = (cfg.dropout_deep,) * (cfg.h_depth + 1)

    def tower_fwd_bwd():
        leaves = [t.detach().requires_grad_(True) for t in _tree.leaves(net0)]
        it = iter(leaves)
        live = _tree.tree_map(lambda _: next(it), net0)
        xin = x_in.detach().requires_grad_(True)
        out = mlp_ops.mlp_forward(live, xin, dropout_rates=rates, train=True, generator=gen)
        return torch.autograd.grad(out.sum(), leaves + [xin])

    net0 = params["deep"]["net_1"]
    tower_ms = cuda_ms(tower_fwd_bwd, args.iters // 2)
    prune_kw = dict(prune_fm=True, prune_deep=True, prune_r=False)
    prune_ms = cuda_ms(lambda: pruning.prune_params(params, 0.3, **prune_kw), 5, warmup=1)
    xi_e = torch.from_numpy(xi[:BATCH]).to(dev)
    xv_e = torch.from_numpy(xv[:BATCH]).to(dev)
    with torch.inference_mode():
        eval_ms = cuda_ms(lambda: deepfwfm.forward(params, xi_e, xv_e, cfg), args.iters // 2)
    wall, busy, top = profile_top(step, calls=10)
    every_op = profile_top(step, calls=5, top=10000)[2]
    ops_per_step = sum(count for _, _, count in every_op)
    kinds = {"optimizer's _foreach kernels": ("multi_tensor_apply",),
             "matrix products": ("gemm", "gemv"),
             "gather and scatter-add": ("index", "scatter", "gather"),
             "copies and fills": ("Memcpy", "Memset", "FillFunctor")}
    by_kind = dict.fromkeys(list(kinds) + ["other elementwise and reductions"], (0.0, 0.0))
    for key, ms, count in every_op:
        kind = next((k for k, words in kinds.items() if any(w in key for w in words)),
                    "other elementwise and reductions")
        by_kind[kind] = (by_kind[kind][0] + ms, by_kind[kind][1] + count)
    check(all(np.isfinite(v) and v > 0 for v in (step_ev, step_host, fb_ms, opt_ms, look_ms,
                                                  tower_ms, prune_ms, eval_ms)), "a time")
    phase(11, f"training times, B={TRAIN_BATCH}, Adam + L2, dropout on {where}")
    print(f"  train step: {step_ev:.4f} ms between CUDA events (median of {args.iters}), "
          f"{step_host:.4f} ms by the host clock ({n_host} steps, one sync) = "
          f"{TRAIN_BATCH / step_host * 1e3:.0f} examples/s {where}")
    print(f"  parts of a step (CUDA events, each alone): loss and gradients {fb_ms:.4f} ms | "
          f"optimizer update {opt_ms:.4f} ms | emb2 lookup forward+backward {look_ms:.4f} ms | "
          f"tower forward+backward {tower_ms:.4f} ms {where}")
    print(f"  prune refresh over the whole model {prune_ms:.4f} ms | eval forward of a "
          f"{BATCH}-row batch {eval_ms:.4f} ms {where}")
    print(f"  profile of a train step: {wall:.3f} ms per step under the profiler, device "
          f"operations {busy:.3f} ms ({busy / wall:.0%} busy; {busy / step_host:.0%} of the "
          f"unprofiled step), {ops_per_step:g} device operations a step {where}")
    for key, ms, count in top:
        print(f"    {ms:.4f} ms  x{count:g}  {key}")
    print("  device time of a step by kind of operation: "
          + " | ".join(f"{k} {ms:.4f} ms in {n:g}" for k, (ms, n) in by_kind.items())
          + f" {where}")
    tmp.cleanup()
    return {"launches_training_path": train_launches, "max_abs_err_trained": trained_err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=100, help="timed calls per kernel")
    args = ap.parse_args(argv)

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xsdeepfwfm_deprecated_torch.compression.quantization import (
        convert, quantized_forward, quantized_lookup_serving)
    from xsdeepfwfm_deprecated_torch.entry import flagship_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda import _build
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import (
        int8_mlp, int8_mlp_reference, max_active_clusters, prof_steps, tower_route,
        untile_weight)
    from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase(1, f"device {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
             f"cuda {torch.version.cuda}")
    print(card, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    libs = {name: _build.load(name) for name in _build.sources()}
    phase(2, f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
    n_clusters, smem = max_active_clusters(416, 512)
    print(f"  tower kernel at W=416: {smem} bytes of dynamic shared memory a block, the card "
          f"holds {n_clusters} clusters of 8 blocks at once (B={BATCH} is {BATCH // 512})")

    # ---- 3. model
    cfg = flagship_config(full_criteo=True)
    params_cpu = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg, device="cpu")
    reqs = make_requests(cfg, args.seed + 1)
    rows = params_cpu["emb2"]["dense"].shape[0]
    check(rows == 1_326_055, f"flagship has {rows} packed rows")
    phase(3, f"flagship {cfg.model_name}: {rows} packed rows, E={cfg.embedding_size}, "
             f"tower {cfg.field_size * cfg.embedding_size}->{'x'.join(map(str, cfg.deep_layers))}"
             f"->1, {deepfwfm.param_count(params_cpu)} params, requests {list(REQUEST_SIZES)}")

    # ---- 4-5. the main path: fp32 then int8 serving, through the Predictor
    int8_mlp.launches = 0
    pred = Predictor(params_cpu, cfg)
    fp32_out = []
    for xi, xv in reqs:
        out = pred.logits(xi, xv)
        check(out.shape == (xi.shape[0],) and np.isfinite(out).all(), "fp32 logits not finite")
        fp32_out.append(out)
    check(int8_mlp.launches == 0, "fp32 serving launched the int8 tower")
    want = Predictor(params_cpu, cfg, device="cpu").logits(*reqs[0])
    err = float(np.abs(fp32_out[0] - want).max())
    np.testing.assert_allclose(fp32_out[0], want, rtol=TOL, atol=TOL)
    phase(4, f"fp32 serving: {len(reqs)} requests, B=8192 logits vs CPU max |diff| {err:.3e}")

    qm_cpu = convert(params_cpu, cfg, "dynamic")
    pred_q = Predictor(qm_cpu)
    int8_out = []
    for xi, xv in reqs:
        before = int8_mlp.launches
        out = pred_q.logits(xi, xv)
        check(out.shape == (xi.shape[0],) and np.isfinite(out).all(), "int8 logits not finite")
        fused = xi.shape[0] % 512 == 0
        check(int8_mlp.launches == before + int(fused),
              f"B={xi.shape[0]}: int8 tower launches {before} -> {int8_mlp.launches}")
        int8_out.append(out)
    launches = int8_mlp.launches
    check(launches == 3, f"int8 tower launched {launches} times on the main path")
    xi_t, xv_t = (torch.from_numpy(a) for a in reqs[0])
    want = quantized_forward(qm_cpu, xi_t, xv_t, use_fused_kernel=True).numpy()
    err_q = float(np.abs(int8_out[0] - want).max())
    np.testing.assert_allclose(int8_out[0], want, rtol=0, atol=TOL)
    phase(5, f"int8 serving: {len(reqs)} requests, tower launches {launches}, "
             f"B=8192 logits vs CPU max |diff| {err_q:.3e}, "
             f"model {qm_cpu.size_bytes()} bytes")

    # ---- 6. both kernels against the plain version on the card
    dev = pred_q.device
    qm = pred_q._model
    spec = deepfwfm.make_embedding_spec(cfg)
    xi_d, xv_d = xi_t.to(dev), xv_t.to(dev)
    with torch.inference_mode():
        x = quantized_lookup_serving(qm.emb2_q, spec, xi_d, xv_d).reshape(BATCH, -1)
        x = x.contiguous()
        layers, fc = qm.fused_tower
        width = layers[0][0].shape[1]
        check(tower_route(width, 512, len(layers)) == "cluster", "the main path's route")
        plain = int8_mlp_reference(x, layers, fc)
        errs = {}
        for route in ("cluster", "layered"):
            got = int8_mlp(x, layers, fc, route=route)
            torch.cuda.synchronize()
            errs[route] = float((got - plain).abs().max())
        max_err, layered_err = errs["cluster"], errs["layered"]
        check(max(errs.values()) <= TOL, f"int8_mlp vs plain version: max |diff| {errs}")
        shapes = [f"main path B={BATCH} block_b=512 (16 clusters of 8): cluster {max_err:.3e} "
                  f"layered {layered_err:.3e}"]
        for in_dim, hidden, b, block_b in ((50, [40, 40], 256, 128),
                                           (390, [400, 400, 400], 2 * BATCH, 512)):
            layers_s, fc_s = seeded_tower(in_dim, hidden, args.seed + 2, dev)
            x_s = tiles_with_different_scales(b, in_dim, block_b, args.seed + 3).to(dev)
            plain_s = int8_mlp_reference(x_s, layers_s, fc_s, block_b=block_b)
            line = f"B={b} block_b={block_b} ({b // block_b} clusters of {block_b // 64}):"
            for route in ("cluster", "layered"):
                got = int8_mlp(x_s, layers_s, fc_s, block_b=block_b, route=route)
                torch.cuda.synchronize()
                err = float((got - plain_s).abs().max())
                check(err <= TOL, f"{line} {route} vs plain version: max |diff| {err}")
                line += f" {route} {err:.3e}"
            shapes.append(line)
        layers_kn = tuple((untile_weight(w).T.contiguous(), s, b) for w, s, b in layers)
        fc_kn = torch.zeros((fc[0].shape[0], 8), dtype=torch.int8, device=dev)
        fc_kn[:, 0] = fc[0]
        lib = int_mm_tower(x, layers_kn, fc_kn, fc[1], 512)
        lib_err = float((lib - plain).abs().max())
        check(lib_err <= TOL, f"torch._int_mm tower vs plain version: max |diff| {lib_err}")
        # the cluster route allocates its output and nothing else
        peaks = {}
        for route in ("cluster", "layered"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            int8_mlp(x, layers, fc, route=route)
            torch.cuda.synchronize()
            peaks[route] = torch.cuda.max_memory_allocated() - before
        check(peaks["cluster"] <= BATCH * 4 + 512, f"cluster route allocated {peaks['cluster']} B")
    phase(6, f"int8_mlp vs plain version on the card, max |diff| (tol {TOL}; torch._int_mm "
             f"yardstick {lib_err:.3e}):")
    for line in shapes:
        print(f"  {line}")
    print(f"  memory a tower call allocates: cluster route {peaks['cluster']} B (the output), "
          f"layered route {peaks['layered']} B")

    # ---- 7. times
    def tower(route):
        return lambda: int8_mlp(x, layers, fc, route=route)

    with torch.inference_mode():
        # device time by graph replay, the two routes in turns
        k_ms = graph_ms(tower("cluster"))
        layered_ms = graph_ms(tower("layered"))
        k_ms = min(k_ms, graph_ms(tower("cluster")))
        layered_ms = min(layered_ms, graph_ms(tower("layered")))
        one_wave = graph_ms(lambda: int8_mlp(x[:BATCH - 512], layers, fc, route="cluster"))
        one_wave_layered = graph_ms(lambda: int8_mlp(x[:BATCH - 512], layers, fc,
                                                     route="layered"))
        # one launch at a time between CUDA events: host gaps included
        k_ev = cuda_ms(tower("cluster"), args.iters)
        layered_ev = cuda_ms(tower("layered"), args.iters)
        p_ms = cuda_ms(lambda: int8_mlp_reference(x, layers, fc), max(args.iters // 4, 10))
        l_ms = cuda_ms(lambda: int_mm_tower(x, layers_kn, fc_kn, fc[1], 512),
                       max(args.iters // 4, 10))
        kernels_per_call = {}
        for route in ("cluster", "layered"):
            _, _, top = profile_top(tower(route), calls=10, top=100)
            kernels_per_call[route] = sum(count for _, _, count in top)
        prof = torch.zeros(64, dtype=torch.int64, device=dev)
        for _ in range(3):
            int8_mlp(x, layers, fc, route="cluster", prof=prof)
        torch.cuda.synchronize()
        steps = prof_steps(len(layers))
        clocks = prof.cpu().tolist()[:len(steps)]
        look_ms = cuda_ms(lambda: quantized_lookup_serving(qm.emb2_q, spec, xi_d, xv_d),
                          args.iters)
        fwd_q_ms = cuda_ms(lambda: quantized_forward(qm, xi_d, xv_d, use_fused_kernel=True),
                           args.iters // 4)
        fwd_ms = cuda_ms(lambda: deepfwfm.forward(pred._model, xi_d, xv_d, cfg,
                                                  lookup_fn=packed_lookup_serving),
                         args.iters // 4)
    check(kernels_per_call["cluster"] == 1, f"kernels per tower call: {kernels_per_call}")
    bound_ms, bound_by, n_bytes, n_ops = tower_bound(qm.deep_q, BATCH, x.numel() * 4)
    e2e_fp32 = host_ms(lambda: pred.logits(*reqs[0]), 20)
    e2e_int8 = host_ms(lambda: pred_q.logits(*reqs[0]), 20)
    one_fp32 = host_ms(lambda: pred.logits(*reqs[3]), 50)
    one_int8 = host_ms(lambda: pred_q.logits(*reqs[3]), 50)
    where = f"[{card}]"
    phase(7, f"times, B={BATCH} {where}")
    print(f"  tower, device time (CUDA-graph replay of 20 calls, median of 10): cluster kernel "
          f"{k_ms:.4f} ms | layered route {layered_ms:.4f} ms | "
          f"at B={BATCH - 512} (one wave of clusters): cluster kernel {one_wave:.4f} ms, layered "
          f"route {one_wave_layered:.4f} ms {where}")
    print(f"  tower, one launch between CUDA events (median of {args.iters}, host gaps "
          f"included): cluster kernel {k_ev:.4f} ms | layered route {layered_ev:.4f} ms | plain "
          f"{p_ms:.4f} ms | torch._int_mm chain {l_ms:.4f} ms {where}")
    print(f"  bound {bound_ms:.5f} ms by {bound_by} ({n_bytes} B, {n_ops} int8 ops); kernels per "
          f"tower call: cluster route {kernels_per_call['cluster']:g}, layered route "
          f"{kernels_per_call['layered']:g} (memset included) {where}")
    print(f"  cluster kernel, SM clock of its first block, {clocks[-1] - clocks[0]} cycles "
          f"from first to last reading {where}:")
    for i in range(1, len(steps)):
        print(f"    {clocks[i] - clocks[i - 1]:7d}  {steps[i]}")
    print(f"  device forward: fp32 {fwd_ms:.4f} ms, int8 {fwd_q_ms:.4f} ms "
          f"(int8 lookup {look_ms:.4f} ms, tower {k_ev:.4f} ms) {where}")
    print(f"  Predictor.logits end to end (host clock, H2D+D2H included): "
          f"fp32 {e2e_fp32:.3f} ms = {BATCH / e2e_fp32 * 1e3:.0f} ex/s, "
          f"int8 {e2e_int8:.3f} ms = {BATCH / e2e_int8 * 1e3:.0f} ex/s {where}")
    print(f"  Predictor.logits at B=1 (host clock, median of 50): fp32 {one_fp32:.3f} ms, "
          f"int8 {one_int8:.3f} ms {where}")
    for name, pred_x in (("fp32", pred), ("int8", pred_q)):
        wall, busy, top = profile_top(lambda: pred_x.logits(*reqs[0]))
        print(f"  profile {name} Predictor.logits: {wall:.3f} ms per call under the profiler, "
              f"kernels {busy:.3f} ms ({busy / wall:.0%} busy) {where}")
        for key, ms, count in top:
            print(f"    {ms:.4f} ms  x{count:g}  {key}")
        if name == "int8":
            tower_rows = [(key, count) for key, _, count in top if "tower_kernel" in key]
            check(len(tower_rows) == 1 and tower_rows[0][1] == 1,
                  f"the int8 request's tower is not one kernel per call: {tower_rows}")
            check(not any("gemm_kernel" in key or "Memset" in key for key, _, _ in top),
                  "the int8 request still runs the layered route")

    # ---- 8-11. the training path
    trained = training_phases(args, cfg, card)

    # ---- 12-13. result lines
    kernels = [{
        "name": "int8_mlp", "route": "cuda",
        "source": "xsdeepfwfm_deprecated_torch/csrc/int8_mlp.cu",
        "replaces": "xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26",
        "launches": launches, "max_abs_err": max_err, "max_abs_diff": max_err, **trained,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": l_ms,
        "layered_ms": layered_ms, "layered_max_abs_err": layered_err,
        "kernels_per_call": kernels_per_call["cluster"],
        "layered_kernels_per_call": kernels_per_call["layered"],
        "one_wave_ms": one_wave, "one_wave_layered_ms": one_wave_layered,
        "event_ms": k_ev, "layered_event_ms": layered_ev}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
