#!/usr/bin/env python3
"""Serve, train and deploy the full-Criteo DeepFwFM flagship through the PyTorch port on one NVIDIA GPU.

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
 12. data: get_dataset("tiny-criteo") through the port's readers (which reader ran is
     printed); a seeded dataset in the criteo on-disk format at the full-Criteo
     cardinalities, written to a temporary directory, read back and equal to what was written
 13. cli.main_all.main with the flagship flags: 2 epochs on tiny-criteo (real rows: the test
     AUC is printed), then 1 epoch on the seeded criteo directory with structured pruning;
     each run fits, reloads its checkpoint, reports the size and runs run_benchmark on the
     card, and the reloaded model's logits equal the port's CPU forward of the checkpoint
 14. cli.quantization.main on the pruned checkpoint, dynamic and static: the fused tower
     kernel launches during the dynamic benchmark and in no other; the saved artifacts load
     back through load_quantized with identical logits
 15. compaction of the structured-pruned model, fp32 and int8, with and without row
     compaction: Predictor(CompactModel) at B=8192 against the dense forward on the card and
     against the CPU's compact_forward; the report; request times dense against compact
 16. cli.kd.main and cli.nfm.main on tiny-criteo, one epoch each: finite metrics, a smaller
     student, NFM's logits on the card equal to the CPU's within 1e-5 of the largest
 17. sharded training: 4 ranks (spawned; nccl with a card each, else gloo on card 0) on a
     (2 data, 2 model) mesh fit the flagship through a2a_grid, a2a and psum, 8 global batches
     of 2,048 each, dropout on: the first step's loss within 1e-6 and its gradients against
     the unsharded step and the same rows in the ranks' pieces; the logits after the fit
     against the one-rank fit, the pieces fit and each other; the a2a_grid model gathered,
     saved, loaded on one device with identical logits and served in fp32 and int8 (the fused
     tower launched and held to its plain version); a pruned epoch's sparsity against one
     rank's; distillation under a2a_grid (the a2a_grid model teaching cli.kd's student) and
     QAT under psum: the first step against the unsharded step, QAT's tower-input scale equal
     to one rank's to the bit, a fit each; the QAT model gathered, converted and served in
     int8 through the fused tower, held to its plain version and the CPU; dropout at rate
     0.3 on the card equal to the CPU's bit for bit; ms per sharded step beside the
     unsharded one, and the bytes of each collective a step. On four cards, also cli.main_all,
     cli.kd and cli.quantization -quantization_aware 1 under torchrun over NCCL.
     --sharded-only runs phases 1 to 3 and this one, without the result lines
 18. quality at scale through xsdeepfwfm_deprecated_torch.tools: 1M synthetic rows at the
     full-Criteo cardinalities (seed 0): the oracle test AUC equals the JAX package's record;
     one dense epoch reaches the AUC floor; DeepLight (warm 1, 1 pruned epoch, Omega 0.5)
     reaches its DNN and embedding sparsities; int8_auc_parity serves the dense checkpoint in
     fp32, int8 layerwise and int8 fused, the fused tower launching once per 8192-row batch,
     equal to its plain version, the fused AUC within 2e-4 of fp32.
     --scale-only runs phases 1 to 3 and this one, without the result lines
 19. the bin input pipeline through tools.host_pipeline_41m: 1M rows at the full-Criteo
     cardinalities generated into the binary layout in a temporary directory; the native
     CSV loader's ingest rate on a 100,000-row sample (an unavailable loader fails); the
     host epoch stream; the whole epoch (488 steps of 2,048) fed through prefetch_to_device
     into train_step on the card, with wall_over_budget against a cached batch's steps and
     wall_over_staged_budget against the loop's last batches staged on the card; the rows
     the card trained on equal a second host pass of epoch_batches, by an exact digest of
     every row; the trained model served in int8 at B=8192, the fused tower launching once
     and equal to its plain version.
     --pipeline-only runs phases 1 to 3 and this one, without the result lines
--parity CHECKPOINT CACHE runs phases 1 to 3, then tools.int8_auc_parity on a checkpoint saved
by tools.synthetic_scale_run and its --cache, with the fused tower's launches (one per 8192-row
batch of the test slice) and its max |diff| against the plain version on the first batch; the
three arms' AUCs within 2e-4 (the 41.3M-row run's serving check), without the result lines.
then one JSON line of per-kernel results, the card's line, and as the last line
{"ok": true, "device": {...}}.
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


FLAGSHIP_FLAGS = ["-use_fwfm", "1", "-use_fm", "0", "-use_logit", "0", "-use_deep", "1",
                  "-use_lw", "1", "-use_fwlw", "1", "-embedding_size", "10",
                  "-deep_nodes", "400", "-h_depth", "3", "-batch_size", str(TRAIN_BATCH)]
CRITEO_ROWS = {"train": 65_536, "valid": 16_384, "test": 16_384}
CLI_TOL = dict(rtol=1e-4, atol=1e-4)   # card against CPU: float32 sums in another order


def write_criteo_dir(root: str, cfg, seed: int) -> dict:
    """A seeded dataset in the ``criteo`` on-disk format under ``root``:
    ``large/criteo_feature_map`` (``field,raw,index`` lines, one for each index
    from 1 on) and ``large/criteo_{train,valid,test}.csv`` (label, 13 numeric
    values, 26 mapped indices). Numeric values are multiples of 1/64, which a
    decimal of six places holds exactly. Returns what was written, by split."""
    import os
    large = os.path.join(root, "large")
    os.makedirs(large)
    num = cfg.numerical
    entries = [np.stack([np.full(size - 1, num + 1 + f), np.arange(1, size), np.arange(1, size)],
                        axis=1)
               for f, size in enumerate(cfg.feature_sizes[num:]) if size > 1]
    np.savetxt(os.path.join(large, "criteo_feature_map"), np.concatenate(entries),
               fmt="%d", delimiter=",")
    written = {}
    for i, (split, n) in enumerate(CRITEO_ROWS.items()):
        xi, xv, y = make_training_rows(cfg, seed + i, n)
        xv = (np.round(xv * 64.0) / 64.0).astype(np.float32)
        np.savetxt(os.path.join(large, f"criteo_{split}.csv"),
                   np.concatenate([y[:, None], xv, xi], axis=1, dtype=np.float64),
                   fmt=["%d"] + ["%.6f"] * num + ["%d"] * xi.shape[1], delimiter=",")
        written[split] = (xi, xv, y)
    return written


def deploy_phases(args, cfg, card: str) -> dict:
    """Phases 12 to 16: data, the four CLIs, compaction. Returns what the
    kernels line reports of the int8 tower on this path."""
    import contextlib
    import os
    import tempfile

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.cli import kd, main_all, nfm, quantization
    from xsdeepfwfm_deprecated_torch.compression.quantization import QuantizedModel
    from xsdeepfwfm_deprecated_torch.data import get_dataset, native_loader, readers
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.models import nfm as nfm_model
    from xsdeepfwfm_deprecated_torch.models.factory import get_model
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.serving.compaction import (
        compact_for_serving, compact_forward, compaction_report)
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor

    where = f"[{card}]"
    bench_keys = ("loss", "auc", "prauc", "rce", "batch_ms", "batch_onchip_ms",
                  "examples_per_s", "single_example_ms", "single_example_onchip_ms")

    def check_benchmark(res: dict, what: str) -> None:
        missing = [k for k in bench_keys if k not in res]
        check(not missing, f"{what}: run_benchmark left out {missing}")
        check(all(np.isfinite(res[k]) for k in bench_keys), f"{what}: a benchmark value")
        check(any(k.startswith("memory/") for k in res), f"{what}: no memory accounting")

    def card_against_cpu(est, xi, xv, strict: bool) -> float:
        """The reloaded model's logits on the card against the CPU forward of
        the checkpoint it was loaded from."""
        check(all(t.device.type == "cuda" for t in _tree.leaves(est.params)), "the CLI left the card")
        cpu = get_model(cfg.field_size, est.mcfg.feature_sizes, model_cfg=est.mcfg,
                        train_cfg=est.tcfg, logger=est.logger, device="cpu")
        cpu.load(est.save_model_name, strict=strict)
        got, want = est._predict_logits(xi, xv), cpu._predict_logits(xi, xv)
        np.testing.assert_allclose(got, want, **CLI_TOL)
        return float(np.abs(got - want).max())

    tmp = tempfile.TemporaryDirectory()
    home = os.getcwd()
    os.chdir(tmp.name)          # the CLIs write ./saved_models and ./logs
    with contextlib.ExitStack() as stack:
        stack.callback(tmp.cleanup)
        stack.callback(os.chdir, home)

        # ---- 12. data
        t0 = time.perf_counter()
        field_size, train, valid, test = get_dataset("tiny-criteo")
        tiny_s = time.perf_counter() - t0
        sizes = train["feature_sizes"]
        check(field_size == 39 and len(sizes) == 39 and list(sizes[:13]) == [1] * 13,
              f"tiny-criteo: field_size {field_size}, feature_sizes {sizes}")
        for name, d in (("train", train), ("test", test)):
            n = d["label"].shape[0]
            check(d["index"].shape == (n, 26) and d["index"].dtype == np.int32
                  and d["value"].shape == (n, 13) and d["value"].dtype == np.float32,
                  f"tiny-criteo {name}: shapes")
            check(set(np.unique(d["label"])) <= {0.0, 1.0}, f"tiny-criteo {name}: labels")
            check(int(d["index"].min()) >= 0 and bool((d["index"].max(axis=0)
                  < np.asarray(sizes[13:])).all()), f"tiny-criteo {name}: an index out of range")
        tiny_reader = readers.LAST_READER
        t0 = time.perf_counter()
        written = write_criteo_dir(tmp.name, cfg, args.seed + 20)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_field, *splits = get_dataset("criteo", data_dir=tmp.name)
        read_s = time.perf_counter() - t0
        check(c_field == 39, "criteo: field_size")
        for (split, (xi, xv, y)), d in zip(written.items(), splits):
            check(tuple(d["feature_sizes"]) == tuple(cfg.feature_sizes),
                  f"criteo {split}: feature_sizes differ from the map that was written")
            check(np.array_equal(d["index"], xi) and np.array_equal(d["value"], xv)
                  and np.array_equal(d["label"], y), f"criteo {split}: read back differs")
        phase(12, f"data: tiny-criteo {train['label'].shape[0]} train and {test['label'].shape[0]} "
                  f"test rows, {sum(sizes)} packed rows, positives {train['label'].mean():.4f}, "
                  f"read in {tiny_s:.2f} s by the {tiny_reader} reader; criteo format at "
                  f"{sum(cfg.feature_sizes)} packed rows: {dict(CRITEO_ROWS)} rows written in "
                  f"{write_s:.2f} s, read in {read_s:.2f} s by the {readers.LAST_READER} reader "
                  f"(native loader available: {native_loader.available()}), equal to what was "
                  f"written")

        # ---- 13. cli.main_all: real rows, then the full-cardinality directory with pruning
        int8_mlp.launches = 0
        t0 = time.perf_counter()
        tiny = main_all.main(["-dataset", "tiny-criteo", "-n_epochs", "2", *FLAGSHIP_FLAGS])
        tiny_fit_s = time.perf_counter() - t0
        check(tiny.mcfg.deep_layers == (400, 400, 400) and tiny.mcfg.embedding_size == 10
              and tiny.mcfg.use_lw and tiny.mcfg.use_fwlw, "main_all did not build the flagship")
        check_benchmark(tiny.benchmark, "main_all on tiny-criteo")
        tiny_err = card_against_cpu(tiny, test["index"], test["value"], strict=True)
        t0 = time.perf_counter()
        pruned = main_all.main(["-dataset", "criteo", "-n_epochs", "1", "-prune", "1",
                                "-prune_deep_structured", "1", "-warm", "0", "-sparse", "0.9",
                                "-prune_omega", "0.2", *FLAGSHIP_FLAGS], data_dir=tmp.name)
        pruned_fit_s = time.perf_counter() - t0
        check(tuple(pruned.mcfg.feature_sizes) == tuple(cfg.feature_sizes), "criteo cardinalities")
        check_benchmark(pruned.benchmark, "main_all on the criteo directory")
        xi_t, xv_t, y_t = written["test"]
        pruned_err = card_against_cpu(pruned, xi_t, xv_t, strict=False)
        net = pruned.params["deep"]["net_1"]
        dead = [float((~(l["w"] != 0).any(dim=0)).float().mean()) for l in net["layers"]]
        n_steps = -(-CRITEO_ROWS["train"] // pruned.tcfg.batch_size)
        target = pruned.tcfg.adaptive_sparse(n_steps)
        check(target > 0.5 and all(abs(d - target) <= 0.01 for d in dead),
              f"structured pruning: dead shares {dead}, schedule {target} after {n_steps} steps")
        check(int8_mlp.launches == 0, "main_all launched the int8 tower")
        phase(13, f"cli.main_all, flagship flags, on the card {where}")
        for name, est, secs, err in (("tiny-criteo, 2 epochs", tiny, tiny_fit_s, tiny_err),
                                     ("criteo directory, 1 pruned epoch", pruned, pruned_fit_s,
                                      pruned_err)):
            b = est.benchmark
            print(f"  {name}: {secs:.1f} s in all; test loss {b['loss']:.6f}, AUC {b['auc']:.6f}, "
                  f"PRAUC {b['prauc']:.4f}, RCE {b['rce']:.2f}; run_benchmark B=8192 "
                  f"{b['batch_ms']:.3f} ms host clock, {b['batch_onchip_ms']:.3f} ms between "
                  f"events = {b['examples_per_s']:.0f} ex/s; B=1 {b['single_example_ms']:.3f} ms "
                  f"host clock, {b['single_example_onchip_ms']:.3f} ms between events; reloaded "
                  f"logits vs the CPU forward of the checkpoint max |diff| {err:.3e} {where}")
        print(f"  tiny-criteo test AUC after 2 epochs, real rows, on the card: "
              f"{tiny.benchmark['auc']:.6f}; dead units a layer after the pruned epoch: "
              + ", ".join(f"{d:.3f}" for d in dead) + f" (schedule {target:.3f}) {where}")

        # ---- 14. cli.quantization on the pruned checkpoint
        t0 = time.perf_counter()
        q = quantization.main(["-dataset", "criteo", "-prune", "1", "-save_model_path",
                               pruned.save_model_name, "-dynamic_quantization", "1",
                               "-static_quantization", "1", *FLAGSHIP_FLAGS], data_dir=tmp.name)
        quant_s = time.perf_counter() - t0
        cli_launches = int8_mlp.launches
        check(q["dynamic"]["tower_launches"] > 0 and q["dynamic"]["tower_launches"] == cli_launches,
              f"the dynamic benchmark launched the fused tower {q['dynamic']['tower_launches']} "
              f"times of {cli_launches}")
        check(q["original"]["tower_launches"] == 0 and q["static"]["tower_launches"] == 0,
              "the fused tower ran outside the dynamic benchmark")
        same = {}
        for mode in ("dynamic", "static"):
            check_benchmark(q[mode]["benchmark"], f"quantization, {mode}")
            qm = q[mode]["model"]
            check(isinstance(qm, QuantizedModel), f"{mode}: not a QuantizedModel")
            back = quantization.load_quantized(f"{pruned.save_model_name}_{mode}_quant",
                                               pruned.mcfg, mode=mode)
            check(back.size_bytes() == qm.size_bytes(), f"{mode}: the artifact's size differs")
            got = Predictor(back).logits(xi_t[:BATCH], xv_t[:BATCH])
            want = Predictor(qm).logits(xi_t[:BATCH], xv_t[:BATCH])
            same[mode] = np.array_equal(got, want)
            check(same[mode], f"{mode}: the loaded artifact's logits differ")
        cli_launches = int8_mlp.launches     # the two dynamic Predictors above launched too
        phase(14, f"cli.quantization on the pruned checkpoint ({quant_s:.1f} s): fused tower "
                  f"launches {q['dynamic']['tower_launches']} in the dynamic benchmark, 0 in the "
                  f"original and the static one; artifacts load back with identical logits {where}")
        for mode in ("original", "dynamic", "static"):
            b = q[mode]["benchmark"]
            print(f"  {mode}: AUC {b['auc']:.6f}, loss {b['loss']:.6f}; B=8192 {b['batch_ms']:.3f} ms "
                  f"host clock, {b['batch_onchip_ms']:.3f} ms between events; B=1 "
                  f"{b['single_example_ms']:.3f} ms host clock {where}")

        # ---- 15. compaction of the structured-pruned model
        params = pruned.params
        dev = pruned.device
        xi_d = torch.from_numpy(xi_t[:BATCH]).to(dev)
        xv_d = torch.from_numpy(xv_t[:BATCH]).to(dev)
        with torch.inference_mode():
            dense = deepfwfm.forward(params, xi_d, xv_d, pruned.mcfg).cpu().numpy()
        preds = {"dense fp32": Predictor(params, pruned.mcfg)}
        lines = []
        for int8 in (False, True):
            for compact_rows in (True, False):
                cm = compact_for_serving(params, pruned.mcfg, int8=int8, compact_rows=compact_rows)
                pred = Predictor(cm)
                got = pred.logits(xi_t[:BATCH], xv_t[:BATCH])
                with torch.inference_mode():
                    on_cpu = compact_forward(cm, torch.from_numpy(xi_t[:BATCH]),
                                             torch.from_numpy(xv_t[:BATCH])).numpy()
                np.testing.assert_allclose(got, on_cpu, **CLI_TOL)
                gap = float(np.abs(got - dense).max())
                if not int8:
                    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
                else:
                    check(np.corrcoef(got, dense)[0, 1] > 0.99, "compact int8 logits")
                rep = compaction_report(params, cm, pruned.mcfg)
                name = f"compact {'int8' if int8 else 'fp32'}" + ("" if compact_rows
                                                                   else ", rows kept")
                preds[name] = pred
                lines.append(f"  {name}: vs the dense forward on the card max |diff| {gap:.3e}, vs "
                             f"the CPU's compact_forward {float(np.abs(got - on_cpu).max()):.3e}; "
                             f"rows {rep['emb2_rows_kept']} of {rep['emb2_rows']}, tower "
                             f"{rep['tower_shapes_compact']} ({rep['tower_mac_reduction']:.2f}x "
                             f"fewer products), {rep['bytes_compact']} of {rep['bytes_full']} bytes")
        check(int8_mlp.launches == cli_launches, "a CompactModel went through the fused tower")
        one = (xi_t[:1], xv_t[:1])
        phase(15, f"compaction of the structured-pruned flagship, B={BATCH} {where}")
        for line in lines:
            print(line)
        for name, pred in preds.items():
            big = host_ms(lambda: pred.logits(xi_t[:BATCH], xv_t[:BATCH]), 20)
            small = host_ms(lambda: pred.logits(*one), 50)
            print(f"  Predictor.logits, {name}: B={BATCH} {big:.3f} ms = "
                  f"{BATCH / big * 1e3:.0f} ex/s, B=1 {small:.3f} ms (host clock, medians of 20 "
                  f"and 50) {where}")

        # ---- 16. cli.kd and cli.nfm on tiny-criteo
        t0 = time.perf_counter()
        teacher, student = kd.main(["-dataset", "tiny-criteo", "-n_epochs", "1",
                                    "-save_model_path", tiny.save_model_name, *FLAGSHIP_FLAGS])
        kd_s = time.perf_counter() - t0
        check_benchmark(student.benchmark, "kd, student")
        check(student.size_bytes < teacher.size_bytes and student.mcfg.h_depth == 2,
              f"the student ({student.size_bytes} B) is not smaller than the teacher")
        check(np.isfinite(student.last_epoch_losses).all(), "kd: losses not finite")
        t0 = time.perf_counter()
        net_nfm = nfm.main(["-dataset", "tiny-criteo", "-n_epochs", "1", *FLAGSHIP_FLAGS])
        nfm_s = time.perf_counter() - t0
        check(all(np.isfinite(v) for v in net_nfm.test_metrics), "nfm: metrics not finite")
        check("fc_w" not in net_nfm.params["deep"] and "net_1" not in net_nfm.params["deep"],
              "the NFM tree")
        got = net_nfm._predict_logits(test["index"], test["value"])
        with torch.inference_mode():
            want = nfm_model.forward(_tree.tree_map(lambda t: t.cpu(), net_nfm.params),
                                     torch.from_numpy(test["index"]),
                                     torch.from_numpy(test["value"]), net_nfm.mcfg).numpy()
        # the reference's N(0,1) tables give logits in the hundreds, each a float32 sum of
        # 400 units behind a bi-interaction that cancels: held to 1e-5 of the largest
        # |logit| besides CLI_TOL's rtol
        np.testing.assert_allclose(got, want, rtol=CLI_TOL["rtol"],
                                   atol=1e-5 * float(np.abs(want).max()))
        nfm_err = float(np.abs(got - want).max())
        phase(16, f"cli.kd ({kd_s:.1f} s): teacher {teacher.size_bytes} B, student "
                  f"{student.size_bytes} B ({teacher.size_bytes / student.size_bytes:.2f} times "
                  f"smaller), student test AUC {student.benchmark['auc']:.6f} against the "
                  f"teacher's {teacher.benchmark['auc']:.6f}; cli.nfm ({nfm_s:.1f} s): test loss "
                  f"{net_nfm.test_metrics[0]:.6f}, AUC {net_nfm.test_metrics[1]:.6f}, logits on "
                  f"the card vs the CPU max |diff| {nfm_err:.3e} of max |logit| "
                  f"{float(np.abs(want).max()):.3e} {where}")
    return {"launches_cli_path": q["dynamic"]["tower_launches"]}


SHARD_MESH = (2, 2)          # (data, model): 4 ranks
SHARD_STEPS = 8              # global batches of TRAIN_BATCH a fit
SHARD_EXCHANGES = ("a2a_grid", "a2a", "psum")
SHARD_TIMED = 5              # timed steps a exchange, after one more
FIT_LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)   # the dry run's: a sharded fit, its one-device twin
FLIP_GRAD = 5e-2     # the first step's gradients against the one-rank step (one ReLU flip)
FLIP_LOGIT = 5e-3    # the logits after SHARD_STEPS against the one-rank fit (Adam carries it)


def step_times(fn, device, n: int) -> float:
    """Median ms of ``n`` calls of ``fn`` after one: between CUDA events on the
    card, by the host clock elsewhere (a rehearsal on the CPU)."""
    fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sharded_rows(cfg, seed: int, sizes):
    """The training rows of phase 17 and the rows its logits are read on.
    ``sizes``: (global batch, steps, rows read)."""
    batch, steps, n_eval = sizes
    return (make_training_rows(cfg, seed + 30, batch * steps),
            make_training_rows(cfg, seed + 31, n_eval)[:2])


def sharded_train_config(seed: int, batch: int, exchange: str = "a2a_grid", mesh=(1, 1),
                         **overrides):
    from xsdeepfwfm_deprecated_torch.entry import flagship_train_config
    return flagship_train_config(n_epochs=1, batch_size=batch, random_seed=seed,
                                 mesh_data=mesh[0], mesh_model=mesh[1], exchange=exchange,
                                 **overrides)


PRUNE_17 = dict(prune=True, warm=0, sparse=0.9, prune_interval=4, prune_omega=2.0)


def first_step(rank: int, est, full, batch0, gen_of, to_dev, seed: int, *, pieces: bool,
               ref_forward=None, forward=None) -> dict:
    """The first step of a sharded fit from the seeded parameters ``full``
    (``est`` shards them), its loss and reduced gradients, against the
    unsharded step from the same parameters and dropout numbers and, with
    ``pieces``, the same rows in the ranks' pieces on one device (a loss
    whose softmax or scale spans the batch has no pieces form). Both
    references run on rank 0, which returns the comparisons. A KD batch
    carries ``teacher``; ``ref_forward``/``forward`` replace the two sides'
    forwards."""
    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.train import trainer
    cfg, tc, device, mesh = est.mcfg, est.tcfg, est.device, est.mesh
    batch, axes = tc.batch_size, est._batch_axes()
    teacher = lambda b: {"teacher_logits": b["teacher"]} if "teacher" in b else {}
    res = {}
    if rank == 0:
        whole = to_dev({k: v for k, v in batch0.items() if k != "count"})
        ref_loss, ref_grads = trainer.loss_and_grads(
            full, whole, cfg, tc, generator=torch.Generator(device=device).manual_seed(seed + 1),
            forward_fn=ref_forward or type(est).model_forward, **teacher(whole))
        if pieces:     # the same rows in the ranks' pieces: the tower's products at their shapes
            n_pieces, parts = mesh.axis_size(axes), []
            for r in range(n_pieces):
                rows = slice(r * batch // n_pieces, (r + 1) * batch // n_pieces)
                piece = {k: (v[rows] if isinstance(v, np.ndarray) and v.ndim else v)
                         for k, v in batch0.items()}
                parts.append(trainer.loss_and_grads(full, to_dev(piece), cfg, tc,
                                                    generator=gen_of(rows)))
            piece_loss = sum(float(p[0]) for p in parts)
            piece_grads = [sum(gs) for gs in zip(*(p[1] for p in parts))]
            del parts
    est._shard_state()
    local0 = to_dev(mesh_mod.shard_batch(batch0, mesh, axes, batch))
    loss, grads = trainer.loss_and_grads(
        est.params, local0, cfg, tc, generator=gen_of(mesh_mod.batch_rows(mesh, axes, batch)),
        forward_fn=forward or est._forward_fn(), group=est._batch_group(), **teacher(local0))
    est._reducer()(grads)
    loss = float(mesh.all_reduce(loss, axes))
    names = [n for n, _ in _tree.named_leaves(est.params)]
    full_grads = est._full(_tree.rebuild(est.params, dict(zip(names, grads))))
    if rank == 0:
        rel = lambda g, r: float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        res["first_loss"], res["first_loss_err"] = loss, abs(loss - float(ref_loss))
        res["grad_errs"] = {name: rel(g, r) for (name, g), r in
                            zip(_tree.named_leaves(full_grads), ref_grads)}
        res["grad_err"] = max(res["grad_errs"].values())
        if pieces:
            res["piece_loss_err"] = abs(loss - piece_loss)
            res["piece_errs"] = {name: rel(g, r) for (name, g), r in
                                 zip(_tree.named_leaves(full_grads), piece_grads)}
            res["piece_err"] = max(res["piece_errs"].values())
    return res


def sharded_rank(rank: int, device, seed: int, cfg, sizes, workdir: str,
                 profile: bool = False) -> dict:
    """One rank of phase 17: for each exchange, the first step from the seeded
    parameters against the unsharded step and against the same rows in the
    ranks' pieces (both on rank 0, from the same parameters and dropout
    numbers), a fit of SHARD_STEPS global batches, its logits, timed steps,
    the bytes of one step's collectives and, with ``profile``, a profile of a
    step; the a2a_grid model gathered and saved; a pruned fit. Every rank
    returns the same logits; rank 0 also the comparisons."""
    import logging
    import os

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.train import trainer

    quiet = logging.getLogger(f"chip_smoke.rank{rank}")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    batch = sizes[0]
    (xi, xv, y), (xi_e, xv_e) = sharded_rows(cfg, seed, sizes)
    to_dev = lambda b: {k: (torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape).to(device)
                            if isinstance(v, np.ndarray) else v) for k, v in b.items()}
    t_rank = time.perf_counter()
    out = {"exchanges": {}}
    mesh = mesh_mod.make_mesh(*SHARD_MESH, device=device)    # one set of groups for every fit
    batch0 = next(batching.iter_batches(xi, xv, y, batch))
    batch0["count"] = np.asarray(batch0["n_valid"], np.float32)
    gen_of = lambda rows: BatchShard(torch.Generator(device=device).manual_seed(seed + 1),
                                     batch, rows.start)
    for exchange in SHARD_EXCHANGES:
        t_exchange = time.perf_counter()
        tc = sharded_train_config(seed, batch, exchange, SHARD_MESH)
        res = out["exchanges"][exchange] = {}
        # the first step, against the unsharded step from the same parameters
        est = trainer.DeepFMEstimator(cfg, tc, logger=quiet, device=device)
        est.mesh = mesh
        full = est.init_params()
        est._setup_mesh()
        axes = est._batch_axes()
        res.update(first_step(rank, est, full, batch0, gen_of, to_dev, seed, pieces=True))
        gen = gen_of(mesh_mod.batch_rows(mesh, axes, batch))
        del full, est
        # the fit, its logits, and timed steps on its state
        est = trainer.DeepFMEstimator(cfg, tc, logger=quiet, device=device)
        est.mesh = mesh
        t0 = time.perf_counter()
        est.fit(xi, xv, y)
        res["fit_s"] = time.perf_counter() - t0
        res["losses"] = est.last_epoch_losses
        res["shards"] = est._table_shards
        res["logits"] = est._predict_logits(xi_e, xv_e)
        if exchange == "a2a_grid":
            path = os.path.join(workdir, "sharded_flagship")
            t0 = time.perf_counter()
            est.save(path, epoch=0)
            res["save_s"] = time.perf_counter() - t0
            gathered = est.gather_params()      # also the teacher of the KD leg below
            if rank == 0:
                one = trainer.DeepFMEstimator(cfg, sharded_train_config(seed, batch),
                                              logger=quiet, device=device)
                one.params = gathered
                out["ckpt"], out["gathered_logits"] = path, one._predict_logits(xi_e, xv_e)
        # timed steps on the fit's state, then the collectives of one step
        cycle = [to_dev(b) for b in est._local_batches(
            batching.iter_batches(xi[:4 * batch], xv[:4 * batch], y[:4 * batch], batch))]
        opt, reduce = trainer.make_optimizer(tc), est._reducer()
        step_i = iter(range(10 ** 6))

        def step():
            return trainer.train_step(est.params, est.opt_state, cycle[next(step_i) % 4], cfg,
                                      tc, opt, reduce=reduce, generator=gen,
                                      forward_fn=est._forward_fn())

        res["step_ms"] = step_times(step, device, SHARD_TIMED)
        mesh.traffic.clear()
        step()
        res["traffic"] = list(mesh.traffic)
        if profile and device.type == "cuda":
            res["profile"] = profile_top(step, calls=3, top=6)
        res["exchange_s"] = time.perf_counter() - t_exchange
        del est, cycle
    # a pruned epoch, sharded over the grid
    est = trainer.DeepFMEstimator(cfg, sharded_train_config(seed, batch, "a2a_grid", SHARD_MESH,
                                                            **PRUNE_17),
                                  logger=quiet, device=device)
    est.mesh = mesh
    t0 = time.perf_counter()
    est.fit(xi, xv, y)
    out["prune_fit_s"] = time.perf_counter() - t0
    out["prune_sparsity"] = est.epoch_sparsity
    out["backend"] = est.mesh.backend
    del est
    out.update(kd_qat_rank(rank, device, seed, cfg, sizes, mesh, gathered, batch0, gen_of,
                           to_dev, quiet))
    out["rank_s"] = time.perf_counter() - t_rank
    return out


KD_EXCHANGE, QAT_EXCHANGE = "a2a_grid", "psum"   # the batch's ranks: the world, then `data`


def recording(scales: list, amax_fn=None):
    """A QAT ``amax_fn`` that appends each abs-max the tower's scales take."""
    def record(amax):
        out = amax if amax_fn is None else amax_fn(amax)
        scales.append(float(out))
        return out
    return record


def kd_qat_rank(rank: int, device, seed: int, cfg, sizes, mesh, teacher_params, batch0, gen_of,
                to_dev, quiet) -> dict:
    """Phase 17's distillation and QAT legs on one rank: KD under a2a_grid,
    the a2a_grid fit's gathered model teaching a student with cli.kd's
    400x2 tower; QAT under psum. Each: the first step against the unsharded
    step (loss, gradients and, for QAT, every activation scale), a fit of
    SHARD_STEPS global batches, its eval logits, timed steps and one step's
    collectives. Rank 0 also returns the QAT fit's gathered parameters."""
    import dataclasses
    from functools import partial

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.cli.kd import STUDENT_DEEP_NODES, STUDENT_H_DEPTH
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.train import trainer

    batch = sizes[0]
    (xi, xv, y), (xi_e, xv_e) = sharded_rows(cfg, seed, sizes)
    teacher = trainer.DeepFMEstimator(cfg, sharded_train_config(seed, batch), logger=quiet,
                                      device=device)
    teacher.params = teacher_params
    cycle_rows = (xi[:4 * batch], xv[:4 * batch], y[:4 * batch])
    teacher_cycle = teacher._predict_logits(*cycle_rows[:2])
    legs = {"kd": (dataclasses.replace(cfg, deep_nodes=STUDENT_DEEP_NODES,
                                       h_depth=STUDENT_H_DEPTH), KD_EXCHANGE, teacher),
            "qat": (dataclasses.replace(cfg, quantization_aware=True), QAT_EXCHANGE, None)}
    out = {}
    for leg, (leg_cfg, exchange, leg_teacher) in legs.items():
        t_leg = time.perf_counter()
        tc = sharded_train_config(seed, batch, exchange, SHARD_MESH)
        est = trainer.DeepFMEstimator(leg_cfg, tc, logger=quiet, device=device)
        est.mesh = mesh
        full = est.init_params()
        est._setup_mesh()
        scales, scales_one, kw = [], [], {}
        if leg == "qat":
            kw = dict(ref_forward=partial(deepfwfm.forward, amax_fn=recording(scales_one)),
                      forward=partial(deepfwfm.forward, lookup_fn=est._lookup_fn,
                                      amax_fn=recording(scales, est._batch_group().max)))
        first = {**batch0, "teacher": teacher_cycle[:batch]} if leg_teacher else batch0
        res = out[leg] = first_step(rank, est, full, first, gen_of, to_dev, seed, pieces=False,
                                    **kw)
        res.update(scales=scales, scales_one=scales_one, exchange=exchange)
        gen = gen_of(mesh_mod.batch_rows(mesh, est._batch_axes(), batch))
        del full, est
        # the fit, its eval logits (QAT: every eval batch's scales over the ranks)
        est = trainer.DeepFMEstimator(leg_cfg, tc, logger=quiet, device=device)
        est.mesh = mesh
        t0 = time.perf_counter()
        est.fit(xi, xv, y, teacher_model=leg_teacher)
        res["fit_s"] = time.perf_counter() - t0
        res["losses"] = est.last_epoch_losses
        res["logits"] = est._predict_logits(xi_e, xv_e)
        if leg == "qat":
            gathered = est.gather_params()
            if rank == 0:
                res["params"] = _tree.tree_map(lambda t: t.to("cpu", copy=True), gathered)
            del gathered
        # timed steps on the fit's state, then the collectives of one step
        batches = batching.iter_batches(*cycle_rows, batch)
        if leg_teacher:
            batches = trainer._with_teacher(batches, teacher_cycle, batch)
        cycle = [to_dev(b) for b in est._local_batches(batches)]
        opt, reduce, fwd = trainer.make_optimizer(tc), est._reducer(), est._forward_fn()
        step_i = iter(range(10 ** 6))

        def step():
            b = cycle[next(step_i) % 4]
            return trainer.train_step(est.params, est.opt_state, b, leg_cfg, tc, opt,
                                      reduce=reduce, generator=gen, forward_fn=fwd,
                                      group=est._batch_group(), teacher_logits=b.get("teacher"))

        res["step_ms"] = step_times(step, device, SHARD_TIMED)
        mesh.traffic.clear()
        step()
        res["traffic"] = list(mesh.traffic)
        res["leg_s"] = time.perf_counter() - t_leg
        del est, cycle
    return out


def pieces_fit(cfg, tc, rows, n_pieces: int, device):
    """The arithmetic of a sharded fit on one device: every step's loss and
    gradients computed on ``n_pieces`` row pieces of the global batch, each
    with its own generator advanced by the global batch's shape (as each
    rank's), summed, then one optimizer update. Its tower products have the
    ranks' shapes, which the one-rank fit's do not. Returns the parameters."""
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard
    from xsdeepfwfm_deprecated_torch.train import trainer
    xi, xv, y = rows
    b, p = tc.batch_size, tc.batch_size // n_pieces
    params = deepfwfm.init_params(torch.Generator().manual_seed(tc.random_seed), cfg,
                                  device=device)
    opt = trainer.make_optimizer(tc)
    state = opt.init(params)
    gens = [BatchShard(torch.Generator(device=device).manual_seed(tc.random_seed + 1), b, r * p)
            for r in range(n_pieces)]
    for batch in batching.iter_batches(xi, xv, y, b):
        count = torch.tensor(float(batch["n_valid"]), device=device)
        grads = None
        for r in range(n_pieces):
            piece = {k: torch.from_numpy(batch[k][r * p:(r + 1) * p]).to(device)
                     for k in ("xi", "xv", "y", "mask")}
            g = trainer.loss_and_grads(params, {**piece, "count": count}, cfg, tc,
                                       generator=gens[r])[1]
            grads = g if grads is None else [a + c for a, c in zip(grads, g)]
        opt.update(params, grads, state)
    return params


@torch.no_grad()
def relu_flips(cfg, params, rows, seed: int, batch: int, n_pieces: int):
    """Per hidden layer of the tower, in the first step's train-mode forward
    (same dropout): the pre-activations whose sign differs between the whole
    batch's products and ``n_pieces`` row pieces', and the largest difference
    of a pre-activation."""
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
    from xsdeepfwfm_deprecated_torch.ops import mlp as mlp_ops
    dev = params["bias"].device
    xi, xv = (torch.from_numpy(a[:batch]).to(dev) for a in rows[:2])
    x = emb_ops.packed_lookup(params["emb2"], deepfwfm.make_embedding_spec(cfg), xi, xv)
    rates = (cfg.dropout_deep,) * (cfg.h_depth + 1)

    def pre_activations(x_in, gen):
        zs = []
        mlp_ops.mlp_forward(params["deep"]["net_1"], x_in, dropout_rates=rates, train=True,
                            generator=gen, activation=lambda z: zs.append(z) or torch.relu(z))
        return zs

    whole = pre_activations(x, torch.Generator(device=dev).manual_seed(seed + 1))
    p = batch // n_pieces
    parts = [pre_activations(x[r * p:(r + 1) * p], mlp_ops.BatchShard(
        torch.Generator(device=dev).manual_seed(seed + 1), batch, r * p)) for r in range(n_pieces)]
    out = []
    for layer, z in enumerate(whole):
        zp = torch.cat([part[layer] for part in parts])
        out.append((int(((z > 0) != (zp > 0)).sum()), float((z - zp).abs().max())))
    return out


def torchrun_clis(card: str) -> None:
    """With a card for each of four ranks: the training CLIs under
    torchrun on a (2, 2) mesh over NCCL, on tiny-criteo with the flagship's
    flags. cli.main_all writes the teacher, then cli.kd and
    cli.quantization -quantization_aware 1 train from it. Prints each
    command's seconds and rank 0's lines of the mesh and the test metrics."""
    import glob
    import os
    import subprocess
    import tempfile
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    flags = ["-dataset", "tiny-criteo", "-n_epochs", "1", *FLAGSHIP_FLAGS, "-mesh_data", "2",
             "-mesh_model", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        def run(module: str, extra) -> None:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "4", "-m", f"xsdeepfwfm_deprecated_torch.cli.{module}",
                   *flags, *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                                 timeout=600)
            check(res.returncode == 0 and "backend nccl" in res.stdout,
                  f"torchrun cli.{module}: exit {res.returncode}\n{res.stdout[-3000:]}\n"
                  f"{res.stderr[-3000:]}")
            lines = [line.split(" - INFO - ", 1)[-1].strip() for line in res.stdout.splitlines()
                     if "mesh:" in line or "\tAcc:" in line or "tower launches" in line]
            print(f"  torchrun cli.{module} on 4 cards, {time.perf_counter() - t0:.1f} s: "
                  + "; ".join(lines) + f" [{card}]", flush=True)

        run("main_all", [])
        teacher = glob.glob(os.path.join(tmp, "saved_models", "*.npz"))[0][:-len(".npz")]
        run("kd", ["-save_model_path", teacher])
        run("quantization", ["-save_model_path", teacher, "-quantization_aware", "1"])


def sharded_phase(args, cfg, card: str) -> dict:
    """Phase 17: sharded training on the card. Returns what the kernels line
    reports of the int8 tower on this path."""
    import dataclasses
    import logging
    import os
    import tempfile
    import threading

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.cli.kd import STUDENT_DEEP_NODES, STUDENT_H_DEPTH
    from xsdeepfwfm_deprecated_torch.compression.quantization import (
        convert, quantized_forward, quantized_lookup_serving)
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp, int8_mlp_reference
    from xsdeepfwfm_deprecated_torch.ops.mlp import dropout
    from xsdeepfwfm_deprecated_torch.parallel.launch import run_ranks
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.train import trainer

    where = f"[{card}]"
    t_phase = time.perf_counter()
    quiet = logging.getLogger("chip_smoke.sharded")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    n_ranks = SHARD_MESH[0] * SHARD_MESH[1]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= n_ranks else "gloo"
    devices = [f"cuda:{r}" if backend == "nccl" else "cuda:0" for r in range(n_ranks)]
    sizes = (TRAIN_BATCH, SHARD_STEPS, BATCH)
    rows, (xi_e, xv_e) = sharded_rows(cfg, args.seed, sizes)
    xi, xv, y = rows
    tc_one = sharded_train_config(args.seed, TRAIN_BATCH)

    # the one-rank reference: the same fit on the card, and its step time
    one = trainer.DeepFMEstimator(cfg, tc_one, logger=quiet)
    dev = one.device
    flips = relu_flips(cfg, one.init_params(), rows, args.seed, TRAIN_BATCH, n_ranks)
    one.fit(xi, xv, y)
    one_logits = one._predict_logits(xi_e, xv_e)
    cycle = list(batching.prefetch_to_device(batching.iter_batches(
        xi[:4 * TRAIN_BATCH], xv[:4 * TRAIN_BATCH], y[:4 * TRAIN_BATCH], TRAIN_BATCH), dev))
    opt = trainer.make_optimizer(one.tcfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    step_i = iter(range(10 ** 6))
    one_ms = step_times(lambda: trainer.train_step(one.params, one.opt_state,
                                                   cycle[next(step_i) % 4], cfg, one.tcfg, opt,
                                                   generator=gen), dev, SHARD_TIMED)
    del cycle

    # the ranks run while this process computes the rest of the references (after
    # the one-rank step was timed alone)
    tmp = tempfile.TemporaryDirectory()
    box: dict = {}

    def launch():
        try:
            box["results"] = run_ranks(sharded_rank, n_ranks, backend=backend, devices=devices,
                                       workdir=tmp.name, args=(args.seed, cfg, sizes, tmp.name,
                                                               args.profile_sharded),
                                       timeout_s=300.0)
        except BaseException as e:    # re-raised below, in this thread
            box["error"] = e

    t0 = time.perf_counter()
    ranks = threading.Thread(target=launch)
    ranks.start()
    # the sharded fits' arithmetic on one device: 4 pieces (a2a family), 2 (psum)
    piece_logits = {}
    for n_pieces in (n_ranks, SHARD_MESH[0]):
        one.params = pieces_fit(cfg, tc_one, rows, n_pieces, dev)
        piece_logits[n_pieces] = one._predict_logits(xi_e, xv_e)
    one_pruned = trainer.DeepFMEstimator(cfg, sharded_train_config(args.seed, TRAIN_BATCH,
                                                                   **PRUNE_17),
                                         logger=quiet).fit(xi, xv, y)
    del one
    refs_s = time.perf_counter() - t0
    ranks.join()
    ranks_s = time.perf_counter() - t0
    if "error" in box:
        raise box["error"]
    results = box["results"]
    r0 = results[0]
    for exchange, res in r0["exchanges"].items():
        for other in results[1:]:
            check(np.array_equal(other["exchanges"][exchange]["logits"], res["logits"]),
                  f"{exchange}: the ranks returned different logits")
        check(len(res["losses"]) == SHARD_STEPS and bool(np.isfinite(res["losses"]).all()),
              f"{exchange}: losses")
        pieces = piece_logits[n_ranks if exchange != "psum" else SHARD_MESH[0]]
        res["one_gap"] = float(np.abs(res["logits"] - one_logits).max())
        res["piece_gap"] = float(np.abs(res["logits"] - pieces).max())
        res["piece_ok"] = bool(np.allclose(res["logits"], pieces, **FIT_LOGIT_TOL))
    logits = {ex: res["logits"] for ex, res in r0["exchanges"].items()}
    cross = max(float(np.abs(logits[a] - logits[b]).max())
                for a in logits for b in logits if a < b)
    cross_ok = all(np.allclose(logits[a], logits[b], **FIT_LOGIT_TOL)
                   for a in logits for b in logits if a < b)

    # the gathered a2a_grid model: checkpoint, one-device estimator, serving
    fresh = trainer.DeepFMEstimator(cfg, tc_one, logger=quiet)
    fresh.load(r0["ckpt"])
    loaded = fresh._predict_logits(xi_e, xv_e)
    check(np.array_equal(loaded, r0["gathered_logits"]),
          "the checkpoint's logits differ from the gathered model's")
    check(np.allclose(loaded, logits["a2a_grid"], rtol=2e-5, atol=2e-6),
          "the gathered model's logits differ from the sharded eval")
    npz_bytes = os.path.getsize(r0["ckpt"] + ".npz")
    spec = deepfwfm.make_embedding_spec(cfg)

    def tower_against_plain(qm) -> float:
        """The fused tower on a served model's B=BATCH activations against its
        plain version (launches made here are not the path's)."""
        with torch.inference_mode():
            x = quantized_lookup_serving(qm.emb2_q, spec, torch.from_numpy(xi_e).to(dev),
                                         torch.from_numpy(xv_e).to(dev)).reshape(len(xi_e), -1)
            layers, fc = qm.fused_tower
            return float((int8_mlp(x.contiguous(), layers, fc)
                          - int8_mlp_reference(x.contiguous(), layers, fc)).abs().max())

    int8_mlp.launches = 0
    pred = Predictor(fresh.params, cfg)
    fp32 = pred.logits(xi_e, xv_e)
    np.testing.assert_allclose(fp32, loaded, rtol=TOL, atol=TOL)
    pred_q = Predictor(convert(_tree.tree_map(lambda t: t.cpu(), fresh.params), cfg, "dynamic"))
    int8 = pred_q.logits(xi_e, xv_e)
    launches = int8_mlp.launches
    check(launches >= 1 and bool(np.isfinite(int8).all()), f"int8 tower launches {launches}")
    tower_err = tower_against_plain(pred_q._model)
    check(tower_err <= TOL, f"int8_mlp vs plain version on the sharded model: {tower_err}")

    # the QAT model trained on the mesh, gathered, converted and served: the fused tower
    kd, qat = r0["kd"], r0["qat"]
    qcfg = dataclasses.replace(cfg, quantization_aware=True)
    qm_qat = convert(qat["params"], qcfg, "qat")
    before = int8_mlp.launches
    pred_qat = Predictor(qm_qat)
    qat_int8 = pred_qat.logits(xi_e, xv_e)
    qat_launches = int8_mlp.launches - before
    check(qat_launches >= 1 and bool(np.isfinite(qat_int8).all()),
          f"the QAT model: int8 tower launches {qat_launches}")
    qat_cpu = quantized_forward(qm_qat, torch.from_numpy(xi_e), torch.from_numpy(xv_e),
                                use_fused_kernel=True).numpy()
    qat_cpu_err = float(np.abs(qat_int8 - qat_cpu).max())
    np.testing.assert_allclose(qat_int8, qat_cpu, rtol=0, atol=TOL)
    qat_tower_err = tower_against_plain(pred_qat._model)
    check(qat_tower_err <= TOL, f"int8_mlp vs plain version on the QAT model: {qat_tower_err}")
    one_qat = trainer.DeepFMEstimator(qcfg, tc_one, logger=quiet)
    one_qat.params = _tree.tree_map(lambda t: t.to(dev), qat["params"])
    qat_eval_gap = float(np.abs(qat["logits"] - one_qat._predict_logits(xi_e, xv_e)).max())
    del one_qat

    # the dropout divides by a tensor: the card keeps the CPU's values to the bit
    x = torch.randn(TRAIN_BATCH, cfg.deep_nodes, generator=torch.Generator().manual_seed(args.seed))
    drop_cpu = dropout(torch.Generator().manual_seed(args.seed + 1), x, 0.3, True)
    drop_card = dropout(torch.Generator().manual_seed(args.seed + 1), x.to(dev), 0.3, True).cpu()
    kept = drop_cpu != 0
    by_number = (x.to(dev) / (1.0 - 0.3)).cpu()[kept]    # a Python divisor, as before the repair
    by_number_share = float((by_number != drop_cpu[kept]).float().mean())
    check(torch.equal(drop_card, drop_cpu), "dropout at rate 0.3: the card's kept values differ "
          "from the CPU's")
    sp_one, sp_sharded = one_pruned.epoch_sparsity[-1], r0["prune_sparsity"][-1]
    for leg in ("kd", "qat"):
        for other in results[1:]:
            check(np.array_equal(other[leg]["logits"], r0[leg]["logits"])
                  and other[leg]["scales"] == r0[leg]["scales"],
                  f"{leg}: the ranks returned different logits or scales")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase

    phase(17, f"sharded training: {n_ranks} ranks on a {SHARD_MESH[0]}x{SHARD_MESH[1]} mesh, "
              f"backend {r0['backend']}, ranks on {sorted(set(devices))}, the flagship at "
              f"global B={TRAIN_BATCH}, Adam + L2, dropout on, {SHARD_STEPS} steps an exchange; "
              f"{phase_s:.1f} s in all, {ranks_s:.1f} s of it in the ranks: "
              f"{ranks_s - r0['rank_s']:.1f} s to start them (CUDA init included; the "
              f"one-device references took {refs_s:.1f} s meanwhile), "
              + ", ".join(f"{ex} {res['exchange_s']:.1f} s" for ex, res in r0["exchanges"].items())
              + f", the pruned fit {r0['prune_fit_s']:.1f} s, KD {kd['leg_s']:.1f} s, QAT "
              f"{qat['leg_s']:.1f} s {where}")
    print("  the first step's tower pre-activations, the whole batch's products against "
          f"{n_ranks} row pieces' (same dropout): "
          + "; ".join(f"layer {i}: {n} of {TRAIN_BATCH * cfg.deep_nodes} change sign, largest "
                      f"difference {gap:.2e}" for i, (n, gap) in enumerate(flips)) + f" {where}")
    def moved(traffic) -> str:
        by = {}
        for kind, group, size, n_bytes in traffic:
            by.setdefault((kind, group, size), []).append(n_bytes)
        return ", ".join(f"{k} over the {g} group ({n} ranks) {sum(b)} B in {len(b)}"
                         for (k, g, n), b in sorted(by.items()))

    def worst(res) -> str:
        return ", ".join(f"{n} {e:.2e}" for n, e in
                         sorted(res["grad_errs"].items(), key=lambda kv: -kv[1])[:3])

    for exchange, res in r0["exchanges"].items():
        print(f"  {exchange}: table shards {res['shards']}; first step: loss "
              f"{res['first_loss']:.6f}, vs the unsharded step within {res['first_loss_err']:.2e}, gradients within "
              f"{res['grad_err']:.2e} of each leaf's largest (worst: {worst(res)}); vs the same rows in the ranks' pieces on one device: loss within "
              f"{res['piece_loss_err']:.2e}, gradients within {res['piece_err']:.2e}. After "
              f"{SHARD_STEPS} steps, logits of {len(xi_e)} rows: vs the pieces fit on one device "
              f"max |diff| {res['piece_gap']:.3e}, vs the one-rank fit {res['one_gap']:.3e}; fit "
              f"{res['fit_s']:.2f} s; train step {res['step_ms']:.3f} ms between CUDA events "
              f"(median of {SHARD_TIMED}; one rank: {one_ms:.3f} ms); collectives a step: "
              f"{moved(res['traffic'])} {where}")
        if "profile" in res:
            wall, busy, top = res["profile"]
            print(f"    profile of rank 0's step: {wall:.3f} ms under the profiler, device "
                  f"operations {busy:.3f} ms ({busy / wall:.0%} busy); the largest: "
                  + "; ".join(f"{key} {ms:.4f} ms x{n:g}" for key, ms, n in top))
    if r0["backend"] == "gloo":
        print(f"  the ranks share one card over gloo: every collective is staged through the "
              f"host, so these times measure that setup, not NVLink {where}")
    print(f"  logits across the exchanges max |diff| {cross:.3e}; a2a_grid gathered and saved "
          f"({npz_bytes} B, {r0['exchanges']['a2a_grid']['save_s']:.2f} s), loaded on one "
          f"device with identical logits; Predictor fp32 vs the estimator max |diff| "
          f"{float(np.abs(fp32 - loaded).max()):.3e}; int8 tower launches {launches}, int8 vs "
          f"fp32 logits {float(np.abs(int8 - fp32).max()):.3e}, int8_mlp vs plain version "
          f"{tower_err:.3e}; pruned epoch sparsity sharded {sp_sharded:.4f}% vs one rank "
          f"{sp_one:.4f}% {where}")
    for leg, res in (("KD", kd), ("QAT", qat)):
        what = (f"the a2a_grid model teaches a student with cli.kd's tower, "
                f"{STUDENT_H_DEPTH} layers of {STUDENT_DEEP_NODES}" if leg == "KD"
                else "the flagship with fake-quant on the tower")
        print(f"  {leg} under {res['exchange']} ({what}): first step: loss {res['first_loss']:.6f}, "
              f"vs the unsharded step within {res['first_loss_err']:.2e}, gradients within "
              f"{res['grad_err']:.2e} of each leaf's largest (worst: {worst(res)}); fit of "
              f"{SHARD_STEPS} steps {res['fit_s']:.2f} s, last loss {res['losses'][-1]:.6f}; train "
              f"step {res['step_ms']:.3f} ms between CUDA events (median of {SHARD_TIMED}); "
              f"collectives a step: {moved(res['traffic'])} {where}")
    print(f"  QAT scales of the first step's tower input and {cfg.h_depth} hidden activations, "
          f"sharded {qat['scales']} vs one rank {qat['scales_one']} (the input's bit-equal); "
          f"eval logits on the mesh vs one device max |diff| {qat_eval_gap:.3e}; the gathered "
          f"model converted (mode qat) and served at B={len(xi_e)}: int8 tower launches "
          f"{qat_launches}, logits vs the CPU's int8 forward max |diff| {qat_cpu_err:.3e}, "
          f"int8_mlp vs plain version {qat_tower_err:.3e} {where}")
    print(f"  dropout at rate 0.3 on {TRAIN_BATCH}x{cfg.deep_nodes}: the card's kept values equal "
          f"the CPU's bit for bit ({int(kept.sum())} kept); a Python divisor on the card would "
          f"change {by_number_share:.1%} of them {where}")
    # A ReLU input within rounding of zero takes the other side in the whole batch's products
    # than in the ranks' (the flips line), which moves one example's share of a tower
    # gradient: the one-rank step is held to FLIP_GRAD of each leaf's largest, the same rows
    # in the ranks' pieces to 1e-5. Adam carries such a difference into every later step,
    # so the fit is held to the pieces fit at the dry run's tolerance and to the one-rank fit
    # at FLIP_LOGIT
    for exchange, res in r0["exchanges"].items():
        check(res["first_loss_err"] <= 1e-6 and res["piece_loss_err"] <= 1e-6,
              f"{exchange}: the first step's loss: {res['first_loss_err']} from the unsharded "
              f"step's, {res['piece_loss_err']} from the pieces'")
        check(res["piece_err"] <= 1e-5 and res["grad_err"] <= FLIP_GRAD,
              f"{exchange}: gradients {res['piece_err']} from the pieces', {res['grad_err']} "
              f"from the unsharded step's, of each leaf's largest")
        check(res["piece_ok"] and res["one_gap"] <= FLIP_LOGIT,
              f"{exchange}: logits {res['piece_gap']} from the pieces fit's (rtol 2e-4 atol "
              f"2e-5), {res['one_gap']} from the one-rank fit's (atol {FLIP_LOGIT})")
    check(cross_ok, f"logits across the exchanges differ by {cross}")
    check(sp_one > 0 and abs(sp_one - sp_sharded) <= 0.01,
          f"pruned sparsity: sharded {sp_sharded}% against one rank {sp_one}%")
    # KD's softmax and QAT's scale span the batch, so they have no pieces form: each first
    # step is held to the unsharded step as the exchanges are; the tower input's scale is a
    # maximum of the same values on every rank, so it is the one-rank scale to the bit
    for leg, res in (("KD", kd), ("QAT", qat)):
        check(res["first_loss_err"] <= 1e-6 and res["grad_err"] <= FLIP_GRAD,
              f"{leg}: the first step's loss {res['first_loss_err']} and gradients "
              f"{res['grad_err']} from the unsharded step's")
        check(len(res["losses"]) == SHARD_STEPS and bool(np.isfinite(res["losses"]).all()),
              f"{leg}: losses {res['losses']}")
    check(len(qat["scales"]) == cfg.h_depth + 1 and qat["scales"][0] == qat["scales_one"][0],
          f"QAT: the tower input's scale {qat['scales'][:1]} against one rank's "
          f"{qat['scales_one'][:1]}")
    check(qat_eval_gap <= FLIP_LOGIT, f"QAT eval on the mesh against one device: {qat_eval_gap}")
    if backend == "nccl":
        torchrun_clis(card)
    return {"launches_sharded_path": launches + qat_launches,
            "max_abs_err_sharded": max(tower_err, qat_tower_err)}


SCALE_ROWS = 1_000_000
SCALE_ORACLE_AUC = 0.8667      # the oracle test AUC of these rows (seed 0), as the JAX package's
                               # run recorded it: the rows are the same, so to 4 digits
SCALE_DENSE_AUC = 0.825        # least test AUC after one dense epoch (JAX: valid e1 0.8302)
SCALE_DNN_SPARSITY = 89.0      # least DNN sparsity after 391 pruned steps at Omega 0.5 (target 89.96%)
SCALE_EMB_SPARSITY = (40.0, 0.5)   # embedding sparsity, and how far from it
SCALE_FUSED_GAP = 2e-4         # most fused-vs-fp32 test AUC gap


def fused_tower_err(qm, cfg, xi: np.ndarray, xv: np.ndarray) -> float:
    """Max |diff| of the fused int8 tower against its plain version on the
    tower input that a dynamic int8 model ``qm`` makes of one batch of rows
    (launches made here are not the path's)."""
    from xsdeepfwfm_deprecated_torch.compression.quantization import quantized_lookup_serving
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp, int8_mlp_reference

    dev = qm.params_fp["bias"].device
    with torch.inference_mode():
        x = quantized_lookup_serving(qm.emb2_q, deepfwfm.make_embedding_spec(cfg),
                                     torch.from_numpy(xi).to(dev), torch.from_numpy(xv).to(dev))
        x = x.reshape(xi.shape[0], -1).contiguous()
        layers, fc = qm.fused_tower
        return float((int8_mlp(x, layers, fc) - int8_mlp_reference(x, layers, fc)).abs().max())


def first_batch_tower_err(checkpoint: str, cache: str) -> float:
    """:func:`fused_tower_err` on the first 8192-row batch of a synthetic cache,
    through a checkpoint of the flagship's architecture quantized as
    ``int8_auc_parity`` does."""
    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.tools import int8_auc_parity
    from xsdeepfwfm_deprecated_torch.weights import load_jax_checkpoint

    z = np.load(cache)
    xi, xv = z["xi"][:BATCH], z["xv"][:BATCH]
    cfg = int8_auc_parity.model_config(z["feature_sizes"].tolist(), xv.shape[1])
    qm = convert(load_jax_checkpoint(checkpoint, cfg), cfg, mode="dynamic")
    return fused_tower_err(qm, cfg, xi, xv)


def parity_run(checkpoint: str, cache: str, card: str) -> None:
    """``tools.int8_auc_parity`` on a saved checkpoint and its synthetic
    cache, with the fused tower's launches (one per 8192-row batch of the
    test slice) and its max |diff| against the plain version on the first
    batch: the 41.3M-row run's serving check."""
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.tools import int8_auc_parity

    t0 = time.perf_counter()
    int8_mlp.launches = 0
    parity = int8_auc_parity.main(["--checkpoint", checkpoint, "--cache", cache])
    torch.cuda.synchronize()
    launches = int8_mlp.launches
    parity_s = time.perf_counter() - t0
    tower_err = first_batch_tower_err(checkpoint, cache)
    n_test = int8_auc_parity.n_test_rows(int(np.load(cache)["y"].shape[0]))
    n_batches = -(-n_test // BATCH)
    print(f"int8_auc_parity on {checkpoint} ({parity_s:.1f} s): {n_test:,} test rows, fused tower "
          f"launches {launches} for {n_batches} batches of {BATCH}; int8_mlp vs plain version on "
          f"the first batch max |diff| {tower_err:.3e} (tol {TOL}) [{card}]")
    check(launches == n_batches, f"the fused tower launched {launches} times for {n_batches} "
                                 f"batches")
    check(tower_err <= TOL, f"int8_mlp vs plain version: {tower_err}")
    aucs = [parity[arm]["auc"] for arm in ("fp32", "int8-layerwise", "int8-fused")]
    check(max(aucs) - min(aucs) <= SCALE_FUSED_GAP, f"the three arms' AUCs {aucs}")


def scale_phase(card: str) -> dict:
    """Phase 18: quality at scale through ``xsdeepfwfm_deprecated_torch.tools``.
    Returns what the kernels line reports of the int8 tower on this path."""
    import contextlib
    import io
    import os
    import tempfile

    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.tools import int8_auc_parity, synthetic_scale_run

    where = f"[{card}]"

    def tool(main, argv):
        """A tool's main on the card; its JSON lines are printed indented, so
        that no line but the result lines starts with a brace."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ret = main(argv)
        torch.cuda.synchronize()
        for line in out.getvalue().splitlines():
            print(f"  {line}")
        return ret, time.perf_counter() - t0

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    cache, save = os.path.join(tmp.name, "synth1m.npz"), os.path.join(tmp.name, "synth1m")
    common = ["--rows", str(SCALE_ROWS), "--full-criteo-dims", "--seed", "0", "--cache", cache,
              "--eval-train-rows", "100000"]
    int8_mlp.launches = 0
    (oracle, (dense,), _), dense_s = tool(synthetic_scale_run.main,
                                          common + ["--epochs", "1", "--save", save])
    check(f"{oracle:.4f}" == f"{SCALE_ORACLE_AUC:.4f}",
          f"oracle test AUC {oracle:.6f}, the JAX package's {SCALE_ORACLE_AUC}")
    check(dense["test_auc"] >= SCALE_DENSE_AUC,
          f"one dense epoch reached test AUC {dense['test_auc']} < {SCALE_DENSE_AUC}")
    (_, (light,), _), light_s = tool(synthetic_scale_run.main, common + [
        "--deeplight", "--warm", "1", "--prune-epochs", "1", "--prune-omega", "0.5"])
    want_emb, emb_tol = SCALE_EMB_SPARSITY
    check(light["dnn_sparsity_pct"] >= SCALE_DNN_SPARSITY
          and abs(light["emb_sparsity_pct"] - want_emb) <= emb_tol,
          f"DeepLight sparsity: DNN {light['dnn_sparsity_pct']}%, embeddings "
          f"{light['emb_sparsity_pct']}%")
    check(int8_mlp.launches == 0, "the fp32 fits launched the int8 tower")
    parity, parity_s = tool(int8_auc_parity.main,
                            ["--checkpoint", save + "_dense", "--cache", cache])
    launches = int8_mlp.launches
    n_test = int8_auc_parity.n_test_rows(SCALE_ROWS)
    n_batches = -(-n_test // BATCH)
    check(launches == n_batches,
          f"the fused tower launched {launches} times for {n_batches} batches of {BATCH}")
    gap = parity["fused_vs_fp32_auc_gap"]
    check(abs(gap) <= SCALE_FUSED_GAP, f"fused-vs-fp32 AUC gap {gap}")

    tower_err = first_batch_tower_err(save + "_dense", cache)
    check(tower_err <= TOL, f"int8_mlp vs plain version on the scale path: {tower_err}")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    phase(18, f"quality at scale: {SCALE_ROWS:,} synthetic rows at full-Criteo dims, seed 0, "
              f"{phase_s:.1f} s {where}")
    print(f"  oracle test AUC {oracle:.4f} (the JAX package's record: {SCALE_ORACLE_AUC})")
    print(f"  dense, 1 epoch ({dense_s:.1f} s with the data): test AUC {dense['test_auc']} "
          f"(at least {SCALE_DENSE_AUC}), logloss {dense['test_logloss']}")
    print(f"  DeepLight, warm 1 + 1 pruned epoch at Omega 0.5 ({light_s:.1f} s): test AUC "
          f"{light['test_auc']}, DNN sparsity {light['dnn_sparsity_pct']}% (at least "
          f"{SCALE_DNN_SPARSITY}), embeddings {light['emb_sparsity_pct']}% ({want_emb} +- "
          f"{emb_tol}), total {light['sparsity_pct']}%")
    print(f"  int8_auc_parity on the dense checkpoint ({parity_s:.1f} s): AUC fp32 "
          f"{parity['fp32']['auc']}, int8 layerwise {parity['int8-layerwise']['auc']}, int8 "
          f"fused {parity['int8-fused']['auc']} (gap {gap}, at most {SCALE_FUSED_GAP}); fused "
          f"tower launches {launches} for {n_batches} batches of {BATCH}; int8_mlp vs plain "
          f"version on the first batch max |diff| {tower_err:.3e} (tol {TOL})")
    return {"launches_scale_path": launches, "max_abs_err_scale": tower_err}


PIPE_ROWS = 1_000_000
PIPE_SAMPLE = 100_000    # rows of the native-ingest sample
PIPE_K = 8               # steps a timed rep of the budget


def row_digests(index, value, label, lib=np):
    """One exact integer a row: the bits of its indices, values and label,
    weighted by column. The same on numpy arrays and (``lib=torch``) on
    tensors on any device; at most 2^31 * 820 in magnitude, so the sums are
    exact in int64."""
    if lib is np:
        rows = np.concatenate([index, value.view(np.int32), label.view(np.int32)[:, None]], 1)
        return rows.astype(np.int64) @ np.arange(1, rows.shape[1] + 1, dtype=np.int64)
    rows = torch.cat([index, value.view(torch.int32), label.view(torch.int32)[:, None]], 1)
    w = torch.arange(1, rows.shape[1] + 1, dtype=torch.int64, device=rows.device)
    return (rows.long() * w).sum(1)


def pipeline_phase(card: str) -> dict:
    """Phase 19: the bin input pipeline feeding the card's train step, through
    ``tools.host_pipeline_41m``. Returns what the kernels line reports of the
    int8 tower on this path."""
    import contextlib
    import io
    import tempfile

    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.data.sharded_input import ShardedBinPipeline
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.tools import host_pipeline_41m as hp

    where = f"[{card}]"
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    with contextlib.redirect_stdout(io.StringIO()):
        sizes = hp.generate(d, PIPE_ROWS)
    gen_s = time.perf_counter() - t_phase
    native = hp.native_ingest_rate(d, PIPE_SAMPLE)
    check("native_csv_rows_per_s" in native, f"native CSV ingest: {native}")
    host = hp.host_stream_rate(d, TRAIN_BATCH)
    n_steps = PIPE_ROWS // TRAIN_BATCH
    check(host["host_rows"] == n_steps * TRAIN_BATCH, f"host stream: {host}")

    # every batch the train step receives, digested on the card (no copy back until the end)
    digests = []
    step = hp.train_step

    def digesting_step(params, opt_state, batch, *args, **kw):
        digests.append(row_digests(batch["xi"], batch["xv"], batch["y"], lib=torch))
        return step(params, opt_state, batch, *args, **kw)

    int8_mlp.launches = 0
    hp.train_step = digesting_step
    try:
        res, params = hp.card_epoch(d, sizes, TRAIN_BATCH, PIPE_K, n_steps)
    finally:
        hp.train_step = step
    check(int8_mlp.launches == 0, "the train steps launched the int8 tower")
    check(res["card_steps"] == n_steps
          and len(digests) == n_steps + 2 * hp.BUDGET_REPS * PIPE_K,
          f"{res['card_steps']} card steps and {len(digests)} train_step calls for an epoch of "
          f"{n_steps}")
    got = torch.stack(digests[:n_steps]).cpu().numpy()
    pipe = ShardedBinPipeline(d)
    want = np.stack([row_digests(b["index"], b["value"], b["label"])
                     for b in pipe.epoch_batches(TRAIN_BATCH, seed=4, epoch=0)])
    check(np.array_equal(got, want), "the rows the card trained on differ from a second host "
                                     "pass of epoch_batches")

    # the trained model served in int8: the fused tower once, against its plain version
    cfg = hp.model_config(sizes)
    pred = Predictor(convert(params, cfg, "dynamic"))
    xi, xv = np.array(pipe.arrays["index"][:BATCH]), np.array(pipe.arrays["value"][:BATCH])
    int8_mlp.launches = 0
    logits = pred.logits(xi, xv)
    launches = int8_mlp.launches
    check(launches == 1, f"the int8 request launched the fused tower {launches} times")
    check(logits.shape == (BATCH,) and np.isfinite(logits).all(), "int8 logits not finite")
    err = fused_tower_err(pred._model, cfg, xi, xv)
    check(err <= TOL, f"int8_mlp vs plain version on the pipeline's model: {err}")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    phase(19, f"bin input pipeline: {PIPE_ROWS:,} rows at full-Criteo dims, {phase_s:.1f} s "
              f"{where}")
    print(f"  generated in {gen_s:.1f} s; native CSV ingest of {PIPE_SAMPLE:,} rows "
          f"{native['native_csv_rows_per_s']:.0f} rows/s ({native['native_csv_mb_per_s']} MB/s); "
          f"host epoch stream {host['host_rows_per_s']:.0f} rows/s {where}")
    print(f"  card epoch: {res['card_steps']} steps of {TRAIN_BATCH} in {res['card_wall_s']} s "
          f"against a budget of {res['card_step_budget_s']} s ({res['card_step_ms']} ms a step "
          f"on a cached batch): wall_over_budget {res['wall_over_budget']} (host_is_bottleneck "
          f"{res['host_is_bottleneck']}; the digest of each batch is inside the wall); against "
          f"the loop's last batches staged on the card {res['card_step_ms_staged']} ms a step, "
          f"wall_over_staged_budget {res['wall_over_staged_budget']}; waiting "
          f"for batches {res['card_feed_s']} s, {res['card_bin_s']} s of it in epoch_batches; "
          f"pinned H2D {res['h2d_gb_per_s']} GB/s {where}")
    print(f"  the {n_steps} batches the card trained on equal a second host pass, row for row; "
          f"int8 Predictor at B={BATCH}: fused tower launches {launches}, int8_mlp vs plain "
          f"version max |diff| {err:.3e} (tol {TOL})")
    return {"launches_pipeline_path": launches, "max_abs_err_pipeline": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=100, help="timed calls per kernel")
    ap.add_argument("--profile-sharded", action="store_true",
                    help="profile a step of each exchange in phase 17 (the profiler's start on "
                         "every rank adds tens of seconds to the phase)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="phases 1 to 3 and 17 only (for a machine with four cards), without the "
                         "result lines")
    ap.add_argument("--scale-only", action="store_true",
                    help="phases 1 to 3 and 18 only, without the result lines")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="phases 1 to 3 and 19 only, without the result lines")
    ap.add_argument("--parity", nargs=2, metavar=("CHECKPOINT", "CACHE"),
                    help="phases 1 to 3, then tools.int8_auc_parity on a saved checkpoint with "
                         "the fused tower's launches and its max |diff| against the plain "
                         "version, without the result lines")
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

    if args.sharded_only:
        sharded_phase(args, cfg, card)
        print(card)
        return 0
    if args.scale_only:
        scale_phase(card)
        print(card)
        return 0
    if args.pipeline_only:
        pipeline_phase(card)
        print(card)
        return 0
    if args.parity:
        parity_run(*args.parity, card)
        print(card)
        return 0

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
    # B=1 int8, the layerwise tower: with the float32 copies of the int8 codes that the model
    # keeps, and converting the codes on every call as before they were kept; in turns
    per_call = Predictor(qm_cpu)
    per_call._model.__dict__["deep_f"] = {
        name: {"layers": [None] * len(net["layers"]), "fc": None}
        for name, net in qm.deep_q.items()}
    check(np.array_equal(per_call.logits(*reqs[3]), pred_q.logits(*reqs[3])),
          "B=1 int8 logits differ between kept and converted float codes")
    turns = {"kept": [], "converted": []}
    for _ in range(7):
        turns["kept"].append(host_ms(lambda: pred_q.logits(*reqs[3]), 50))
        turns["converted"].append(host_ms(lambda: per_call.logits(*reqs[3]), 50))
    one_int8 = statistics.median(turns["kept"])
    one_int8_converted = statistics.median(turns["converted"])
    ops_one, busy_one = {}, {}
    for name, p in (("kept", pred_q), ("converted", per_call)):
        _, busy_one[name], every_op = profile_top(lambda: p.logits(*reqs[3]), top=10000)
        ops_one[name] = sum(count for _, _, count in every_op)
    check(ops_one["converted"] == ops_one["kept"] + cfg.h_depth + 1,
          f"device operations of a B=1 int8 request: {ops_one}")
    del per_call
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
    print(f"  int8 at B=1 in turns, 7 x 50 calls each (medians "
          + " | ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v) for k, v in turns.items())
          + f"): float32 copies of the codes kept {one_int8:.3f} ms, {ops_one['kept']:g} device "
          f"operations a request taking {busy_one['kept']:.4f} ms | codes converted on every "
          f"call {one_int8_converted:.3f} ms, {ops_one['converted']:g} device operations taking "
          f"{busy_one['converted']:.4f} ms {where}")
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

    # ---- 12-16. the deploy path through the CLIs
    deployed = deploy_phases(args, cfg, card)

    # ---- 17. sharded training
    sharded = sharded_phase(args, cfg, card)

    # ---- 18. quality at scale
    scaled = scale_phase(card)

    # ---- 19. the bin input pipeline
    piped = pipeline_phase(card)

    # ---- result lines
    kernels = [{
        "name": "int8_mlp", "route": "cuda",
        "source": "xsdeepfwfm_deprecated_torch/csrc/int8_mlp.cu",
        "replaces": "xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26",
        "launches": launches, "max_abs_err": max_err, "max_abs_diff": max_err, **trained, **deployed,
        **sharded, **scaled, **piped,
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
