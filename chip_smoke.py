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
     back through load_quantized with identical logits; calibrate's 5 batches are 5 graph
     replays, its scales equal to the eager calibrate's on the same rows bit for bit
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
     unsharded one, and the bytes of each collective a step. Then the grouped fits: 24 global
     batches at steps_per_call=10 against 1 on the same mesh under deterministic algorithms,
     a2a_grid and a pruned leg (a refresh every 10 steps), and on four cards also a2a, psum,
     KD and QAT: the first loss equal, sparsity within two parameters, every value within
     STEP_TOL, the fits' collectives equal, the form fit's mesh line names; the scanned eval
     on the mesh equal to per-batch forwards. On four cards (NCCL) a group is one CUDA
     graph replay on every rank, the short last group too (three a fit), and a step of the
     steps_per_call=1 fit one replay (24 a fit), else the phase fails; 10 steps and a refresh
     as one replay against the same run eagerly give ms a sharded step in both forms beside
     one rank's, with equal bytes; on one card the gloo ranks run the groups eagerly. On four
     cards, also cli.main_all, cli.kd and cli.quantization -quantization_aware 1 under
     torchrun over NCCL, and cli.main_all -steps_per_call 10.
 18. quality at scale through xsdeepfwfm_deprecated_torch.tools: 1M synthetic rows at the
     full-Criteo cardinalities (seed 0): the oracle test AUC equals the JAX package's record;
     one dense epoch reaches the AUC floor; DeepLight (warm 1, 1 pruned epoch, Omega 0.5)
     reaches its DNN and embedding sparsities; int8_auc_parity serves the dense checkpoint in
     fp32, int8 layerwise and int8 fused, the fused tower launching once per 8192-row batch,
     equal to its plain version, the fused AUC within 2e-4 of fp32.
 19. the bin input pipeline through tools.host_pipeline_41m: 1M rows at the full-Criteo
     cardinalities generated into the binary layout in a temporary directory; the native
     CSV loader's ingest rate on a 100,000-row sample (an unavailable loader fails); the
     host epoch stream; the whole epoch (488 steps of 2,048) fed through prefetch_to_device
     into make_multi_step on the card, 8 steps a CUDA graph replay (--k-steps 8), with
     wall_over_budget against replays on a cached group and wall_over_staged_budget against
     the loop's last groups staged on the card; the rows the card trained on equal a second
     host pass of epoch_batches, by an exact digest of every row; the trained model served
     in int8 at B=8192, the fused tower launching once and equal to its plain version.
 20. the compiled dispatch: each CUDA-graphed path against the same path run eagerly on the
     card, host-clock ms and device ms (the device's busy share) of both: the Predictor
     (fp32, dynamic int8 with the fused tower inside its graph, compact) at B=8192 and B=1,
     logits within 1e-6; _predict_logits' scanned groups against per-batch forwards, equal;
     the dropout masks of K graphed steps equal to K eager steps' from the same generator;
     fit on the flagship for an epoch of 64 steps with steps_per_call=10, pruning and
     dropout on (seven replays, six full groups and the tail group of four real steps, and
     no group run eagerly) against steps_per_call=1 from the same state and generator: the
     first loss equal, and under torch's deterministic algorithms the same non-zero count
     and every parameter equal bit for bit, also to the fit with its tail group eager
     (beside it the spread of values and non-zero counts of two fits at steps_per_call=1
     with the card's atomic scatter-add), and the peak allocated memory of the three fits;
     ms a train step graphed and eager; the tail group as one replay against eager; the
     pipeline leg at 1M rows with --k-steps 8, --k-steps 1 (one make_train_step replay a
     step, counted, and the rows trained on equal to a second host pass) and --k-steps 1
     eager.
 21. the compiled timers: run_benchmark on the flagship in fp32 and dynamic int8 at B=8192
     and tools.pruned_serving_bench at B=8192 and B=1 (7 arms), every timer through CUDA
     graph replays (marginal_timeit, scan_timeit and the Predictor's replay): inside each
     timed window only replays, no eager forward and no torch function called; each
     captured forward's logits equal Predictor.logits on its batch within 1e-6; in int8 the
     fused tower launched inside the timers' graphs once a forward and equal to its plain
     version; each reading beside the reading of the eager timers for the same call,
     and the arms' ranking under both.
 22. the per-batch compiled dispatch: fit at its default steps_per_call=1 on the flagship,
     30 steps of 2,048 (the last padded), a refresh every 10, dropout on: every step, refresh
     and eval batch one graph replay (make_train_step, prune_params, make_eval_fn; counted),
     graphed and eager fits in turns under deterministic algorithms equal bit for bit
     (parameters, optimizer state, losses, train AUC), fit seconds, capture seconds and peak
     allocated memory of both; the eval fn's batches against eager forwards; host-clock ms
     a step (median and range) and the device's busy share, graphed against eager, of the
     fit's loop and of the steps alone; then cli.main_all for a checkpoint and
     cli.quantization -dynamic_quantization 1 -quantization_aware 1 at its defaults on
     tiny-criteo: the QAT fit's steps replayed, the fused tower launched in the dynamic
     benchmark and equal to its plain version.
 23. the last compiled forms: HashMLPBaseline at its default width (hash_dim 2048, hidden
     (256, 128), B=1024) on seeded rows at the full-Criteo cardinalities, 2 epochs of 24
     steps: graphed and eager fits in turns under deterministic algorithms, parameters and
     losses equal bit for bit, one replay a step (counted); the test AUC within 1e-5 of the
     CPU port's fit; ms a step graphed and eager by the host clock and device time.
 24. the fused Adam kernel alone at the leaves of the benchmark's two configurations (the
     Criteo flagship, 13,740,101 values, and the Avazu model, 31,209,993): one step equal to
     the plain `_foreach` version bit for bit, then device time as a CUDA graph of 20
     calls (median of 10) beside its bound (28 B a value at 3.35 TB/s), the plain version
     and torch._fused_adam_ (a yardstick only; the port never calls it).
 25. the prune refresh alone at the Criteo configuration's leaves, as the benchmark's cell
     refreshes them (40% of the table zero, a block of rows parked at ~1e-31): the
     kernel's route (csrc/prune_search.cu) equal to the torch path bit for bit, 7 launches
     a refresh, then device time as a CUDA graph of 20 calls (median of 10) beside its
     bound (2 x 4 B a pruned value at 3.35 TB/s) and the torch path's 40 passes (the
     yardstick), a PruneRefresh replay between events, and the refresh's top operations.
 26. xDeepFM's CIN layer kernels (csrc/cin.cu) at the xDeepFM cell's shapes (B=4096, m=39,
     D=10, maps 200 x 3) and at ragged ones: each layer's output and its three gradients
     within 1e-5 of the largest value against the plain (materialized) version, two runs
     bit-equal; device time of the forward and the backward as a CUDA graph of 20 calls
     (median of 10) beside the bound (the FLOP at 67 TFLOP/s fp32), the plain version and
     cuBLAS's z @ W^T on a materialized z (the yardstick); then the cell's training step
     through make_train_step: the kernels' launches on every replay, the step's peak
     memory below one (B*D, H*m) product, ms a step and its top device operations.
 27. DLRM-DCNv2's sparse Adagrad kernel (csrc/bag_adagrad.cu) at the DLRM-DCNv2 cell's
     shapes: a batch of the cell's traffic (B=8192, 214 ids a row) on a full-size table and
     accumulator (26,500,127 rows at E=128): two steps equal to the plain version of the
     kernel's order bit for bit (on a compact copy of the rows the batch reads), a step run
     twice from one state equal to itself, the first step within the cell's limits of the
     torch form (grad_gap, median_change_gap, rows_gap 0), rows off the batch untouched;
     device time as a CUDA graph of 20 calls (median of 10) beside its bound
     (port_bench/dlrm_roofline.update_bytes at 3.35 TB/s) and the torch form's; then the
     cell's training step through make_train_step: the kernel's launches on every replay,
     ms a step and its top device operations.
--phases N [N ...] runs phases 1 to 3, then the listed ones (a number names its group:
4 to 7, 8 to 11, 12 to 16, and 17 to 27 each alone), without the result lines.
--parity CHECKPOINT CACHE runs phases 1 to 3, then tools.int8_auc_parity on a checkpoint saved
by tools.synthetic_scale_run and its --cache, with the fused tower's launches (one per 8192-row
batch of the test slice) and its max |diff| against the plain version on the first batch; the
three arms' AUCs within 2e-4 (the 41.3M-row run's serving check), without the result lines.
then one JSON line of per-kernel results (the fused Adam kernel's launches by phase group,
graph replays counted and a sharded rank's added: above 0 on every path that trains, 0 on
the serving phases 4 to 7 and the timers' phase 21; the CIN's above 0 on phase 26 alone, the
one path that runs xDeepFM; the bags' Adagrad's above 0 on phase 27 alone, the one path that
runs DLRM-DCNv2), the card's line, and as the last line
{"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import logging
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BATCH = 8192
PHASE_GROUPS = ((4, 7), (8, 11), (12, 16), (17, 17), (18, 18), (19, 19), (20, 20),
                (21, 21), (22, 22), (23, 23), (24, 24), (25, 25), (26, 26), (27, 27))
LAST_PHASE = PHASE_GROUPS[-1][1]
TRAIN_BATCH = 2048
TRAIN_BATCHES = 64
REQUEST_SIZES = (BATCH, BATCH, BATCH, 1, 1000)
TOL = 1e-4   # fp32: float32 sums in another order; int8: epilogue rounding
BENCH_CONFIGS = Path(__file__).resolve().parent / "port_bench" / "configs"
BENCH_TRAFFIC = Path(__file__).resolve().parent / "port_bench" / "traffic"
BENCH_LIMITS = Path(__file__).resolve().parent / "port_bench" / "limits"
FP32_FLOP_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores (NVIDIA data sheet)
# phase 26: the kernels against the plain version, of the largest value of a result. Both
# sum the same float32 products in other orders (7,800 terms a value at the cell's layers 2
# and 3), which parts them by a few units in the last place of the terms' magnitudes.
CIN_TOL = 1e-5
CIN_RAGGED = ((11, 7, 203, 161), (5, 5, 7, 83), (200, 39, 200, 4001))   # (H_{k-1}, m, H_k, rows)


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
    from xsdeepfwfm_deprecated_torch.compression import quantization as q_mod
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

        # ---- 14. cli.quantization on the pruned checkpoint; calibrate's replays counted, its
        # scales held to the eager calibrate's on the same rows
        calls = []
        calibrate = q_mod.calibrate

        def recorded(*a, **kw):
            calls.append((a, kw, calibrate(*a, **kw)))
            return calls[-1][2]
        q_mod.calibrate = recorded
        t0 = time.perf_counter()
        try:
            with counting_replays() as replays:
                q = quantization.main(["-dataset", "criteo", "-prune", "1", "-save_model_path",
                                       pruned.save_model_name, "-dynamic_quantization", "1",
                                       "-static_quantization", "1", *FLAGSHIP_FLAGS],
                                      data_dir=tmp.name)
        finally:
            q_mod.calibrate = calibrate
        quant_s = time.perf_counter() - t0
        check(len(calls) == 1 and replays["calibrate"] == calls[0][1]["n_batches"] == 5,
              f"calibrate: {len(calls)} calls, {replays['calibrate']} replays for 5 batches")
        (cal_args, cal_kw, cal_graphed), = calls
        with eager_forms():
            cal_eager = calibrate(*cal_args, **cal_kw)
        cal_scales = list(zip(_tree.leaves(cal_graphed), _tree.leaves(cal_eager)))
        cal_same = all(torch.equal(a, w) for a, w in cal_scales)
        check(cal_same and q["static"]["model"].act_scales is cal_graphed,
              "calibrate's replays differ from the eager calibrate on the same rows")
        cal_rows = cal_kw["batch_size"]
        del cal_args, cal_kw, calls
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
                  f"original and the static one; artifacts load back with identical logits; "
                  f"calibrate {replays['calibrate']} replays of {cal_rows}-row batches, its "
                  f"{len(cal_scales)} scales equal the eager calibrate's bit for bit: "
                  f"{cal_same} {where}")
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
        forward_fn=forward or est.forward_fn, group=est._batch_group(), **teacher(local0))
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
    from xsdeepfwfm_deprecated_torch.ops.cuda.fused_adam import fused_adam
    from xsdeepfwfm_deprecated_torch.ops.cuda.prune_search import prune_search
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.train import trainer

    fused_adam.launches = prune_search.launches = 0
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
                                      forward_fn=est.forward_fn)

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
    t0 = time.perf_counter()
    out["grouped"] = grouped_rank(rank, device, seed, cfg, mesh, gathered, quiet, profile)
    out["grouped_s"] = time.perf_counter() - t0
    out["rank_s"] = time.perf_counter() - t_rank
    out["adam_launches"] = fused_adam.launches     # this rank's steps: fits, KD, QAT, groups
    out["prune_launches"] = prune_search.launches  # this rank's refreshes
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
        opt, reduce, fwd = trainer.make_optimizer(tc), est._reducer(), est.forward_fn
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


GROUP_K = 10                      # steps_per_call of phase 17's grouped fits: a refresh every 10
GROUP_STEPS = 2 * GROUP_K + 4     # global batches of a grouped fit: two full groups, a short one
PRUNE_GROUPED = {**PRUNE_17, "prune_interval": GROUP_K}


class MeshLines(logging.Handler):
    """Keeps the ``mesh:`` lines that a fit logs (on rank 0)."""

    def __init__(self):
        super().__init__()
        self.lines: list = []

    def emit(self, record):
        if record.getMessage().startswith("mesh:"):
            self.lines.append(record.getMessage())


def grouped_rank(rank: int, device, seed: int, cfg, mesh, teacher_params, quiet,
                 profile: bool) -> dict:
    """Phase 17's grouped fits on one rank. Each leg fits GROUP_STEPS global
    batches at steps_per_call=GROUP_K and at 1 on the same mesh under torch's
    deterministic algorithms, counting the graph replays of the first; the
    a2a_grid leg also reads the scanned eval against every batch per batch.
    Over gloo two legs (a2a_grid, and pruned with a refresh every GROUP_K
    steps), whose groups run eagerly; over NCCL also a2a, psum, KD and QAT,
    then, from each fit's state, GROUP_K steps and a refresh as one replay
    against the same run eagerly (ms, the bytes of the collectives and, with
    ``profile``, the device's busy share of both)."""
    import dataclasses

    from xsdeepfwfm_deprecated_torch.cli.kd import STUDENT_DEEP_NODES, STUDENT_H_DEPTH
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.train import trainer

    b = TRAIN_BATCH
    xi, xv, y = make_training_rows(cfg, seed + 32, GROUP_STEPS * b)
    to_dev = lambda d: {k: (torch.from_numpy(np.ascontiguousarray(v)).reshape(v.shape).to(device)
                            if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    teacher = trainer.DeepFMEstimator(cfg, sharded_train_config(seed, b), logger=quiet,
                                      device=device)
    teacher.params = teacher_params
    legs = {"a2a_grid": (cfg, "a2a_grid", {}, None), "pruned": (cfg, "a2a_grid", PRUNE_GROUPED, None)}
    if mesh.capturable:
        legs.update({"a2a": (cfg, "a2a", {}, None), "psum": (cfg, "psum", {}, None),
                     "kd": (dataclasses.replace(cfg, deep_nodes=STUDENT_DEEP_NODES,
                                                h_depth=STUDENT_H_DEPTH), KD_EXCHANGE, {}, teacher),
                     "qat": (dataclasses.replace(cfg, quantization_aware=True), QAT_EXCHANGE, {},
                             None)})
    lines = MeshLines()
    logger = logging.getLogger(f"chip_smoke.grouped{rank}")
    logger.handlers, logger.propagate = [lines], False
    logger.setLevel(logging.INFO)
    out = {}
    for leg, (leg_cfg, exchange, extra, leg_teacher) in legs.items():
        t_leg = time.perf_counter()
        res = out[leg] = {"exchange": exchange}
        fits = {}
        with deterministic():
            for k in (GROUP_K, 1):
                tc = sharded_train_config(seed, b, exchange, SHARD_MESH, steps_per_call=k, **extra)
                est = fits[k] = trainer.DeepFMEstimator(leg_cfg, tc, logger=logger,
                                                        device=device)
                est.mesh = mesh
                mesh.traffic.clear()
                sync()
                t0 = time.perf_counter()
                with counting_replays() as replays:
                    est.fit(xi, xv, y, teacher_model=leg_teacher)
                    sync()
                res[k] = dict(fit_s=time.perf_counter() - t0, losses=est.last_epoch_losses,
                              traffic=list(mesh.traffic),
                              mesh_line=lines.lines.pop() if lines.lines else "",
                              step_replays=named(replays, "make_multi_step"),
                              train_replays=named(replays, "make_train_step"),
                              nonzero=deepfwfm.nonzero_param_count(est.gather_params()))
        res["share"], res["far"] = within_step_tol(fits[GROUP_K].params, fits[1].params)
        est = fits[GROUP_K]
        del fits
        if leg == "a2a_grid":    # eight scanned batches, then a tail, against every batch alone
            n_eval = trainer.EVAL_SCAN_K * b + 1000
            with counting_replays() as replays:
                scanned = est._predict_logits(xi[:n_eval], xv[:n_eval], batch_size=b)
            scan_k, trainer.EVAL_SCAN_K = trainer.EVAL_SCAN_K, 10 ** 9
            try:
                per_batch = est._predict_logits(xi[:n_eval], xv[:n_eval], batch_size=b)
            finally:
                trainer.EVAL_SCAN_K = scan_k
            res["eval"] = dict(rows=n_eval, diff=float(np.abs(scanned - per_batch).max()),
                               replays=named(replays, "make_scan_eval_fn"))
        if mesh.capturable and leg != "pruned":
            res.update(graphed_against_eager(est, leg_cfg, xi, xv, y, leg_teacher, seed, to_dev,
                                             profile))
        res["leg_s"] = time.perf_counter() - t_leg
        del est
    return out


def graphed_against_eager(est, cfg, xi, xv, y, teacher, seed: int, to_dev, profile: bool) -> dict:
    """From a sharded fit's state: GROUP_K steps and a prune refresh as one
    graph replay against the same steps and refresh run eagerly. Returns ms a
    step of both (between CUDA events, median of SHARD_TIMED), the bytes of
    the collectives a step, whether both forms moved the same, and with
    ``profile`` each form's device ms and busy share under the profiler."""
    from xsdeepfwfm_deprecated_torch.compression import pruning
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.ops.mlp import BatchShard
    from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
    from xsdeepfwfm_deprecated_torch.train import trainer

    b, k, tc, mesh, device = TRAIN_BATCH, GROUP_K, est.tcfg, est.mesh, est.device
    batches = batching.iter_batches(xi[:k * b], xv[:k * b], y[:k * b], b)
    if teacher is not None:
        batches = trainer._with_teacher(batches, teacher._predict_logits(xi[:k * b], xv[:k * b]), b)
    local = list(est._local_batches(batches))
    stacked = to_dev(next(batching.stack_groups(local, k)))
    local = [to_dev({key: v for key, v in bt.items() if key != "n_valid"}) for bt in local]
    gen = BatchShard(torch.Generator(device=device).manual_seed(seed + 1), b,
                     mesh_mod.batch_rows(mesh, est._batch_axes(), b).start)
    prune_kw = dict(emb_r=tc.emb_r, emb_corr=tc.emb_corr, prune_fm=True, prune_deep=True,
                    prune_r=tc.prune_r)
    if est._table_shards > 1:
        prune_kw.update(mesh=mesh, table_axes=est._table_axes,
                        dense_rows=type(est).model_spec(cfg).dense_rows)
    opt, reduce, group, fwd = (trainer.make_optimizer(tc), est._reducer(), est._batch_group(),
                               est.forward_fn)
    multi = trainer.make_multi_step(cfg, tc, opt, use_kd=teacher is not None, forward_fn=fwd,
                                    prune_kw=prune_kw, mesh=mesh, reduce=reduce, group=group)

    def graphed():
        multi(est.params, est.opt_state, stacked["xi"], stacked["xv"], stacked["y"],
              stacked["mask"], gen, stacked.get("teacher"), 0.01, k_real=k,
              count_k=stacked["count"])

    def eager():
        for bt in local:
            trainer.train_step(est.params, est.opt_state, bt, cfg, tc, opt, reduce=reduce,
                               generator=gen, forward_fn=fwd, group=group,
                               teacher_logits=bt.get("teacher"))
        pruning.prune_params_(est.params, 0.01, **prune_kw)

    res = {"graphed_ms": step_times(graphed, device, SHARD_TIMED) / k,
           "eager_ms": step_times(eager, device, SHARD_TIMED) / k}
    for name, fn in (("graphed", graphed), ("eager", eager)):
        res[f"{name}_host_ms"] = host_ms(lambda: (fn(), torch.cuda.synchronize(device)),
                                         SHARD_TIMED) / k
    moved = {}
    for name, fn in (("eager", eager), ("graphed", graphed)):
        mesh.traffic.clear()
        fn()
        moved[name] = list(mesh.traffic)
    res["same_bytes"] = moved["graphed"] == moved["eager"]
    res["bytes_step"] = sum(n_bytes for *_, n_bytes in moved["eager"]) / k
    res["collectives_step"] = len(moved["eager"]) / k
    if profile and device.type == "cuda":
        # NCCL's kernels wait on the device for their peers: the compute kernels alone say
        # how busy the rank keeps its card
        res["profile"] = {}
        for name, fn in (("graphed", graphed), ("eager", eager)):
            wall, busy, rows = profile_top(fn, calls=3, top=10 ** 6)
            compute = sum(ms for key, ms, _ in rows if "nccl" not in key.lower())
            res["profile"][name] = (wall, busy, compute, rows[:3])
    return res


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


def nvlink_rate():
    """Card 0's NVLink rate in GB/s a direction, the sum of its links' as
    ``nvidia-smi nvlink -s`` reports them, printed; None where it reports none."""
    import re
    try:
        out = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    links = [float(x) for x in re.findall(r"Link \d+: ([\d.]+) GB/s", out)]
    print(f"  NVLink of card 0 (nvidia-smi nvlink -s): {len(links)} links, "
          f"{sum(links):.1f} GB/s a direction" if links else
          "  NVLink of card 0: nvidia-smi reports no link rate", flush=True)
    return sum(links) or None


def grouped_checks(results: list, backend: str, one_group_ms: dict, where: str) -> None:
    """Phase 17's lines and checks of the grouped fits (``grouped_rank``):
    every leg's fit at steps_per_call=GROUP_K against 1 on the same mesh, its
    replays (over NCCL one a group, the short last group too, and one a step
    at steps_per_call=1; none over gloo, where the steps run eagerly), and
    over NCCL ms a step graphed against eager beside one rank's."""
    r0 = results[0]["grouped"]
    graphed = backend == "nccl"
    nvlink_gbs = nvlink_rate() if graphed else None
    full_groups = GROUP_STEPS // GROUP_K
    groups = -(-GROUP_STEPS // GROUP_K)
    form = f"{GROUP_K} steps a replay" if graphed else f"{GROUP_K} steps eager a group"
    print(f"  grouped fits: {GROUP_STEPS} global batches of {TRAIN_BATCH} at steps_per_call="
          f"{GROUP_K} against 1 on the same mesh, under deterministic algorithms, the pruned leg "
          f"refreshing every {GROUP_K} steps; fit's mesh line: "
          f"\"{r0['a2a_grid'][GROUP_K]['mesh_line']}\" ({results[0]['grouped_s']:.1f} s in all) "
          f"{where}")
    for leg, res in r0.items():
        grouped, single = res[GROUP_K], res[1]
        share = min(r["grouped"][leg]["share"] for r in results)
        far = max(r["grouped"][leg]["far"] for r in results)
        same_traffic = all(r["grouped"][leg][GROUP_K]["traffic"] == r["grouped"][leg][1]["traffic"]
                           for r in results)
        replays = [r["grouped"][leg][GROUP_K]["step_replays"] for r in results]
        single_replays = [r["grouped"][leg][1]["train_replays"] for r in results]
        first_gap = abs(grouped["losses"][0] - single["losses"][0])
        line = (f"  {leg} ({res['exchange']}): {replays[0]} multi-step replays on each rank for "
                f"{full_groups} full groups and a group of {GROUP_STEPS % GROUP_K}, "
                f"{single_replays[0]} train-step replays on each rank at steps_per_call=1 for "
                f"{GROUP_STEPS} steps; first loss {grouped['losses'][0]:.6f} vs "
                f"{single['losses'][0]:.6f}; non-zeros {grouped['nonzero']} vs "
                f"{single['nonzero']}; within STEP_TOL {share:.6f} of the values on every rank "
                f"(furthest {far:.3e}); the fits' collectives equal: {same_traffic}; fit "
                f"{grouped['fit_s']:.2f} s vs {single['fit_s']:.2f} s")
        if "eval" in res:
            ev = res["eval"]
            line += (f"; scanned eval of {ev['rows']} rows ({ev['replays']} replays) vs per "
                     f"batch max |diff| {ev['diff']:.1e}")
        if "graphed_ms" in res:
            line += (f"; a step with a refresh every {GROUP_K}: graphed {res['graphed_ms']:.3f} "
                     f"ms, eager {res['eager_ms']:.3f} ms between CUDA events, graphed "
                     f"{res['graphed_host_ms']:.3f} ms, eager {res['eager_host_ms']:.3f} ms by "
                     f"the host clock (one rank, events: graphed {one_group_ms['graphed']:.3f}, "
                     f"eager {one_group_ms['eager']:.3f}); {res['collectives_step']:.1f} "
                     f"collectives and {res['bytes_step']:.0f} B a step, the same in both forms: "
                     f"{res['same_bytes']}")
            if nvlink_gbs:
                line += (f", {res['bytes_step'] / nvlink_gbs / 1e6:.4f} ms at card 0's NVLink "
                         f"rate")
        print(line + f" {where}", flush=True)
        for form_name, (wall, busy, compute, top) in res.get("profile", {}).items():
            print(f"    profile of rank 0, {GROUP_K} steps and a refresh {form_name}: "
                  f"{wall:.3f} ms under the profiler, device events {busy:.3f} ms, of them "
                  f"compute kernels (NCCL's left out) {compute:.3f} ms ({compute / wall:.0%} "
                  f"busy); the largest: " + "; ".join(f"{key} {ms:.4f} ms x{n:g}"
                                                      for key, ms, n in top) + f" {where}")
        check(form in grouped["mesh_line"] and form not in single["mesh_line"],
              f"{leg}: fit's mesh line names another form than {form!r}: {grouped['mesh_line']}")
        check(replays == [groups if graphed else 0] * len(results),
              f"{leg}: {replays} multi-step replays for {groups} groups over {backend}")
        check(single_replays == [GROUP_STEPS if graphed else 0] * len(results),
              f"{leg}: {single_replays} train-step replays for {GROUP_STEPS} steps over {backend}")
        check(first_gap <= 1e-6, f"{leg}: the first loss differs by {first_gap}")
        check(abs(grouped["nonzero"] - single["nonzero"]) <= 2,
              f"{leg}: non-zeros {grouped['nonzero']} grouped, {single['nonzero']} per batch")
        check(share == 1.0, f"{leg}: {share} of the values within {STEP_TOL}, furthest {far}")
        check(same_traffic, f"{leg}: the grouped fit's collectives differ from the per-batch fit's")
        if "eval" in res:
            check(res["eval"]["diff"] == 0.0 and res["eval"]["replays"] == (1 if graphed else 0),
                  f"scanned eval on the mesh: {res['eval']}")
        if "graphed_ms" in res:
            check(res["same_bytes"], f"{leg}: a replay's collectives differ from the eager steps'")


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
        def run(module: str, extra, expect: str = "backend nccl") -> None:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "4", "-m", f"xsdeepfwfm_deprecated_torch.cli.{module}",
                   *flags, *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                                 timeout=600)
            check(res.returncode == 0 and "backend nccl" in res.stdout and expect in res.stdout,
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
        run("main_all", ["-steps_per_call", str(GROUP_K)], f"{GROUP_K} steps a replay")


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
    from xsdeepfwfm_deprecated_torch.compression import pruning
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
    # the one-rank step with a refresh every GROUP_K, graphed and eager, as the ranks time theirs
    xi_g, xv_g, y_g = make_training_rows(cfg, args.seed + 32, GROUP_K * TRAIN_BATCH)
    group = list(batching.prefetch_to_device(batching.iter_batches(xi_g, xv_g, y_g, TRAIN_BATCH),
                                             dev))
    stacked = {k: torch.stack([bt[k] for bt in group]) for k in ("xi", "xv", "y", "mask")}
    prune_kw = dict(emb_r=one.tcfg.emb_r, emb_corr=one.tcfg.emb_corr, prune_fm=True,
                    prune_deep=True, prune_r=one.tcfg.prune_r)
    multi = trainer.make_multi_step(cfg, one.tcfg, opt, prune_kw=prune_kw)

    def one_eager():
        for bt in group:
            trainer.train_step(one.params, one.opt_state, bt, cfg, one.tcfg, opt, generator=gen)
        pruning.prune_params_(one.params, 0.01, **prune_kw)
    one_group_ms = {
        "graphed": step_times(lambda: multi(one.params, one.opt_state, stacked["xi"],
                                            stacked["xv"], stacked["y"], stacked["mask"], gen,
                                            None, 0.01, k_real=GROUP_K), dev, SHARD_TIMED) / GROUP_K,
        "eager": step_times(one_eager, dev, SHARD_TIMED) / GROUP_K}
    del group, stacked, multi

    # the ranks run while this process computes the rest of the references (after
    # the one-rank step was timed alone)
    tmp = tempfile.TemporaryDirectory()
    box: dict = {}

    def launch():
        try:
            box["results"] = run_ranks(sharded_rank, n_ranks, backend=backend, devices=devices,
                                       workdir=tmp.name, args=(args.seed, cfg, sizes, tmp.name,
                                                               args.profile_sharded),
                                       timeout_s=480.0)
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
    grouped_checks(results, backend, one_group_ms, where)
    if backend == "nccl":
        torchrun_clis(card)
    rank_adam = [r["adam_launches"] for r in results]
    check(all(n > 0 for n in rank_adam), f"fused Adam launches by rank: {rank_adam}")
    return {"launches_sharded_path": launches + qat_launches,
            "max_abs_err_sharded": max(tower_err, qat_tower_err),
            "rank_adam_launches": sum(rank_adam),
            "rank_prune_launches": sum(r["prune_launches"] for r in results)}


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
PIPE_K = 8               # steps a multi-step dispatch (the script's --k-steps)


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

    # every batch of every group the multi-step receives, digested on the card (no copy back
    # until the end)
    digests = []
    make = hp.make_multi_step

    def digesting_multi_step(*args, **kw):
        multi = make(*args, **kw)

        def step(params, opt_state, xi_k, xv_k, y_k, *rest, **kw2):
            digests.extend(row_digests(xi_k[i], xv_k[i], y_k[i], lib=torch)
                           for i in range(xi_k.shape[0]))
            return multi(params, opt_state, xi_k, xv_k, y_k, *rest, **kw2)
        return step

    int8_mlp.launches = 0
    hp.make_multi_step = digesting_multi_step
    try:
        res, params = hp.card_epoch(d, sizes, TRAIN_BATCH, PIPE_K, n_steps)
    finally:
        hp.make_multi_step = make
    check(int8_mlp.launches == 0, "the train steps launched the int8 tower")
    check(res["card_steps"] == n_steps
          and len(digests) == n_steps + 2 * hp.BUDGET_REPS * PIPE_K,
          f"{res['card_steps']} card steps and {len(digests)} batches dispatched for an epoch "
          f"of {n_steps}")
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
    print(f"  card epoch, {PIPE_K} steps a graph replay: {res['card_steps']} steps of "
          f"{TRAIN_BATCH} in {res['card_wall_s']} s against a budget of "
          f"{res['card_step_budget_s']} s ({res['card_step_ms']} ms a step on a cached group): "
          f"wall_over_budget {res['wall_over_budget']} (host_is_bottleneck "
          f"{res['host_is_bottleneck']}; the digest of each batch is inside the wall); against "
          f"the loop's last batches staged on the card {res['card_step_ms_staged']} ms a step, "
          f"wall_over_staged_budget {res['wall_over_staged_budget']}; waiting "
          f"for batches {res['card_feed_s']} s, {res['card_bin_s']} s of it in epoch_batches; "
          f"pinned H2D {res['h2d_gb_per_s']} GB/s {where}")
    print(f"  the {n_steps} batches the card trained on equal a second host pass, row for row; "
          f"int8 Predictor at B={BATCH}: fused tower launches {launches}, int8_mlp vs plain "
          f"version max |diff| {err:.3e} (tol {TOL})")
    return {"launches_pipeline_path": launches, "max_abs_err_pipeline": err}


DISPATCH_FIT_K = 10     # phase 20's graphed fit: steps_per_call (the tools' default)
DISPATCH_REPS = 50      # host-clock calls of a Predictor form in each turn
GRAPH_TOL = 1e-6        # graphed against eager logits: the same kernels on the same inputs


@contextlib.contextmanager
def counting_replays():
    """Every CUDA graph replay inside the block, counted by the graph's name."""
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph
    seen = collections.Counter()
    replay = cuda_graph.Graphed.replay

    def counted(self):
        seen[self.name] += 1
        return replay(self)
    cuda_graph.Graphed.replay = counted
    try:
        yield seen
    finally:
        cuda_graph.Graphed.replay = replay


def named(replays: collections.Counter, function: str) -> int:
    """The replays of ``counting_replays`` of the graphs of ``function``."""
    return sum(n for name, n in replays.items() if function in name)


@contextlib.contextmanager
def eager_forms():
    """Inside the block the port captures nothing, on the card too: each
    graphed form runs as the eager form it replaces."""
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph
    on_card = cuda_graph._on_card
    cuda_graph._on_card = lambda device: False
    try:
        yield
    finally:
        cuda_graph._on_card = on_card


def in_turns(fn_a, fn_b, iters: int):
    """Median host-clock ms of two forms, timed a, b, b, a; the mean of each
    form's two medians."""
    a1, b1 = host_ms(fn_a, iters), host_ms(fn_b, iters)
    b2, a2 = host_ms(fn_b, iters), host_ms(fn_a, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def busy(fn, calls: int) -> str:
    """The device's share of ``fn`` under the profiler, as text."""
    wall, dev_ms, _ = profile_top(fn, calls=calls, top=1)
    return f"device {dev_ms:.4f} ms ({dev_ms / wall:.0%} busy under the profiler)"


def within_step_tol(a: dict, b: dict):
    """(share of values within STEP_TOL, largest |diff|) over two trees."""
    from xsdeepfwfm_deprecated_torch import _tree
    n_close = n_all = 0
    far = 0.0
    for x, w in zip(_tree.leaves(a), _tree.leaves(b)):
        x, w = x.detach().double(), w.detach().double()
        diff = (x - w).abs()
        far = max(far, float(diff.max()))
        n_close += int((diff <= STEP_TOL["atol"] + STEP_TOL["rtol"] * w.abs()).sum())
        n_all += diff.numel()
    return n_close / n_all, far


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block: ``index_add_`` sums
    through a sort in place of atomics, so that the same steps give the same
    bits. ``warn_only``, with the warnings silenced: cuBLAS keeps its own
    workspace setting (the environment's), which the block does not change."""
    import warnings
    was, warn_only = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def dispatch_phase(args, cfg, card: str) -> dict:
    """Phase 20: the JAX package's compiled dispatch as CUDA graphs, each
    graphed path against the same path run eagerly on the card. Returns the
    fused tower's launches through the int8 Predictor's graph replays."""
    import dataclasses
    import io
    import logging
    import tempfile

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.compression import pruning
    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.data.sharded_input import ShardedBinPipeline
    from xsdeepfwfm_deprecated_torch.entry import flagship_train_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops import mlp as mlp_ops
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.serving.compaction import compact_for_serving
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.tools import host_pipeline_41m as hp
    from xsdeepfwfm_deprecated_torch.train import trainer
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph

    quiet = logging.getLogger("chip_smoke.dispatch")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    where = f"[{card}]"
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    lines = []

    # the Predictor: one graph a batch shape, against its eager forward
    params_cpu = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg, device="cpu")
    structured = pruning.prune_params(params_cpu, 0.5, prune_fm=False, prune_deep=True,
                                      structured_deep=True)
    preds = {"fp32": Predictor(params_cpu, cfg),
             "int8": Predictor(convert(params_cpu, cfg, "dynamic")),
             "compact": Predictor(compact_for_serving(structured, cfg))}
    reqs = make_requests(cfg, args.seed + 1)
    graph_launches = 0
    for name, pred in preds.items():
        for xi, xv in (reqs[0], reqs[3]):
            b = xi.shape[0]
            before = int8_mlp.launches
            graphed = pred.logits(xi, xv)
            fused = int(name == "int8" and b % 512 == 0)
            check(int8_mlp.launches == before + fused,
                  f"{name} B={b}: tower launches {before} -> {int8_mlp.launches} in one replay")
            graph_launches += int8_mlp.launches - before

            def eager():
                with torch.inference_mode():
                    return pred._fn(pred._model, torch.from_numpy(xi).to(dev),
                                    torch.from_numpy(xv).to(dev)).cpu().numpy()
            diff = float(np.abs(graphed - eager()).max())
            check(graphed.shape == (b,) and diff <= GRAPH_TOL,
                  f"{name} B={b}: graphed logits differ from eager by {diff}")
            g_ms, e_ms = in_turns(lambda: pred.logits(xi, xv), eager, DISPATCH_REPS)
            lines.append(f"  Predictor {name} B={b}: graphed {g_ms:.3f} ms by the host clock, "
                         f"{busy(lambda: pred.logits(xi, xv), 20)} | eager {e_ms:.3f} ms, "
                         f"{busy(eager, 20)} | max |diff| {diff:.1e}")
        check(len(pred._graphs) == 2, f"{name}: {len(pred._graphs)} graphs for two batch shapes")

    # _predict_logits: EVAL_SCAN_K batches a replay against per-batch forwards
    est = trainer.DeepFMEstimator(cfg, flagship_train_config(), logger=quiet)
    est.params = _tree.tree_map(lambda t: t.to(dev), params_cpu)
    k_eval = trainer.EVAL_SCAN_K
    n_eval = 2 * k_eval * BATCH + 3000
    xi_e, xv_e, _ = make_training_rows(cfg, args.seed + 30, n_eval)

    def per_batch():
        out = []
        with torch.inference_mode():
            for batch in batching.prefetch_to_device(batching.iter_batches(
                    xi_e, xv_e, np.zeros(n_eval, np.float32), BATCH), dev):
                out.append(deepfwfm.forward(est.params, batch["xi"], batch["xv"], cfg)
                           [:batch["n_valid"]])
            return torch.cat(out).cpu().numpy()
    scanned = est._predict_logits(xi_e, xv_e)
    eval_diff = float(np.abs(scanned - per_batch()).max())
    check(eval_diff == 0.0, f"scanned eval differs from per-batch forwards by {eval_diff}")
    s_ms, b_ms = in_turns(lambda: est._predict_logits(xi_e, xv_e), per_batch, 5)
    lines.append(f"  _predict_logits of {n_eval:,} rows (two groups of {k_eval} x {BATCH}, a tail "
                 f"of 3,000): scanned {s_ms:.3f} ms, "
                 f"{busy(lambda: est._predict_logits(xi_e, xv_e), 3)} | per batch {b_ms:.3f} ms, "
                 f"{busy(per_batch, 3)} | max |diff| {eval_diff:.1e}")
    del est

    # dropout: K graphed steps' masks against K eager steps' from the same generator
    b, f, e = TRAIN_BATCH, cfg.field_size, cfg.embedding_size
    draw_shapes = [(b, f), (b, e), (b, f, e)] + [(b, w) for w in cfg.deep_layers]
    ones = [torch.ones(shape, device=dev) for shape in draw_shapes]

    def draws(gen, xs):
        return [mlp_ops.dropout(gen, x, cfg.dropout_deep, True) != 0
                for _ in range(DISPATCH_FIT_K) for x in xs]
    gen_g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    gen_e = torch.Generator(device=dev).manual_seed(args.seed + 5)
    graphed = cuda_graph.Compiled(lambda gen, **xs: draws(gen, list(xs.values())),
                                  "dropout draws", device=dev, writes_state=True)
    inputs = {f"x{i}": x for i, x in enumerate(ones)}
    masks_g = graphed((gen_g,), inputs)
    masks_g += graphed((gen_g,), inputs)     # the second replay draws on from the first
    masks_e = draws(gen_e, ones) + draws(gen_e, ones)
    check(len(graphed) == 1, f"{len(graphed)} graphs of the dropout draws")
    del graphed
    same_masks = all(torch.equal(a, m) for a, m in zip(masks_g, masks_e))
    check(same_masks, "graphed dropout draws differ from the eager steps' draws")

    # fit: an epoch with steps_per_call=10 against steps_per_call=1 (a replay a step, phase
    # 22). The card's scatter-add sums with atomics in any order, and Adam turns the last bit
    # of a gradient near its eps into up to lr a step (phase 8), so two fits already part
    # after 64 steps: that spread is read, and the forms are held to STEP_TOL under torch's
    # deterministic algorithms (the scatter-add sorted), where the same steps give the same bits
    xi_f, xv_f, y_f = make_training_rows(cfg, args.seed + 10, TRAIN_BATCH * TRAIN_BATCHES)
    tc = flagship_train_config(n_epochs=1, batch_size=TRAIN_BATCH, prune=True, warm=0,
                               sparse=0.9, random_seed=args.seed, eval_train_rows=BATCH)
    steps_run, init = trainer.MultiStep._steps, cuda_graph.Graphed.__init__
    call = trainer.MultiStep.__call__

    def tail_eager(self, *a, k_real=None, **kw):
        """The parent's form of a group with padding steps: its steps eager."""
        with eager_forms() if k_real is not None and k_real < a[2].shape[0] \
                else contextlib.nullcontext():
            return call(self, *a, k_real=k_real, **kw)

    def fit(k: int, eager_tail: bool = False):
        """One epoch at steps_per_call=k: (estimator, seconds, multi-step replays, groups or
        steps run eagerly, peak allocated GB above what was live before it)."""
        est_k = trainer.DeepFMEstimator(cfg, dataclasses.replace(tc, steps_per_call=k),
                                        logger=quiet)
        making, eager = [False], [0]

        def counted_steps(self, *a, **kw):  # outside a graph's warm-up and capture: eager
            eager[0] += not making[0]
            return steps_run(self, *a, **kw)

        def marked_init(self, *a, **kw):
            making[0] = True
            try:
                init(self, *a, **kw)
            finally:
                making[0] = False
        trainer.MultiStep._steps, cuda_graph.Graphed.__init__ = counted_steps, marked_init
        if eager_tail:
            trainer.MultiStep.__call__ = tail_eager
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            with counting_replays() as replays:
                est_k.fit(xi_f, xv_f, y_f)
                torch.cuda.synchronize()
        finally:
            trainer.MultiStep._steps, cuda_graph.Graphed.__init__ = steps_run, init
            trainer.MultiStep.__call__ = call
        peak = (torch.cuda.max_memory_allocated() - live) / 1e9
        return est_k, time.perf_counter() - t0, named(replays, "make_multi_step"), eager[0], peak

    n_groups = -(-TRAIN_BATCHES // DISPATCH_FIT_K)     # six full groups and a tail of four
    g_fit, g_s, step_replays, g_eager, _ = fit(DISPATCH_FIT_K)
    e_fit, e_s, _, _, _ = fit(1)
    e2_fit, _, _, _, _ = fit(1)
    check(step_replays == n_groups and g_eager == 0,
          f"{step_replays} multi-step replays for {n_groups} groups, {g_eager} groups eager")
    check(g_fit._step == e_fit._step == TRAIN_BATCHES, "steps of the two fits")
    first_gap = abs(g_fit.last_epoch_losses[0] - e_fit.last_epoch_losses[0])
    check(first_gap <= 1e-6, f"the first step's loss differs by {first_gap} (masks or state)")
    # the refreshes' thresholds follow the parted values, so the non-zero counts of these fits
    # part too (by 0 to 3 in three runs); they are read here and held under deterministic
    # algorithms below, where the two forms must prune the same parameters
    nz = [deepfwfm.nonzero_param_count(x.params) for x in (g_fit, e_fit, e2_fit)]
    share, far = within_step_tol(g_fit.params, e_fit.params)
    share_ee, far_ee = within_step_tol(e2_fit.params, e_fit.params)
    first = (g_fit.last_epoch_losses[0], e_fit.last_epoch_losses[0])
    loss_gap = float(np.abs(np.subtract(g_fit.last_epoch_losses, e_fit.last_epoch_losses)).max())
    del g_fit, e_fit, e2_fit
    with deterministic():
        gd_fit, _, det_replays, gd_eager, gd_peak = fit(DISPATCH_FIT_K)
        ed_fit, _, _, ed_eager, ed_peak = fit(1)
        td_fit, _, td_replays, td_eager, td_peak = fit(DISPATCH_FIT_K, eager_tail=True)
    check(det_replays == n_groups and gd_eager == ed_eager == 0,
          f"{det_replays} deterministic multi-step replays, {gd_eager} and {ed_eager} eager")
    check(td_replays == n_groups - 1 and td_eager == 1, f"the tail-eager fit: {td_replays} "
                                                        f"replays, {td_eager} groups eager")
    nz_d = [deepfwfm.nonzero_param_count(x.params) for x in (gd_fit, ed_fit)]
    check(nz_d[0] == nz_d[1], f"under deterministic algorithms non-zero parameters {nz_d[0]} "
                              f"at K={DISPATCH_FIT_K}, {nz_d[1]} at K=1")
    share_d, far_d = within_step_tol(gd_fit.params, ed_fit.params)
    bitwise_d = all(torch.equal(a, w) for a, w in zip(_tree.leaves(gd_fit.params),
                                                      _tree.leaves(ed_fit.params)))
    bitwise_t = all(torch.equal(a, w) for a, w in zip(_tree.leaves(gd_fit.params),
                                                      _tree.leaves(td_fit.params)))
    check(share_d == 1.0 and bitwise_d and bitwise_t,
          f"deterministic graphed fit: {share_d} of the values within {STEP_TOL}, furthest "
          f"{far_d}; bit for bit against K=1 {bitwise_d}, against the tail eager {bitwise_t}")
    lines.append(f"  fit, one epoch of {TRAIN_BATCHES} x {TRAIN_BATCH}, pruned every "
                 f"{tc.prune_interval} steps, dropout on: steps_per_call={DISPATCH_FIT_K} "
                 f"({step_replays} graph replays, the last a group of "
                 f"{TRAIN_BATCHES % DISPATCH_FIT_K} real steps; {g_eager} groups eager) "
                 f"{g_s:.3f} s (capture included) | steps_per_call=1 {e_s:.3f} s; "
                 f"first loss {first[0]:.6f} vs {first[1]:.6f}, every loss within "
                 f"{loss_gap:.1e}, non-zeros {nz[0]} vs {nz[1]} (a second "
                 f"K=1 fit {nz[2]}); within STEP_TOL: K={DISPATCH_FIT_K} vs K=1 {share:.6f} "
                 f"(furthest {far:.3e}), two K=1 fits {share_ee:.6f} (furthest {far_ee:.3e}); "
                 f"under deterministic algorithms K={DISPATCH_FIT_K} vs K=1 {share_d:.6f} "
                 f"(furthest {far_d:.3e}, bit for bit: {bitwise_d}; against the tail group "
                 f"eager: {bitwise_t}), non-zeros {nz_d[0]} vs {nz_d[1]}; the fit's peak "
                 f"allocated above what was live: K={DISPATCH_FIT_K} {gd_peak:.3f} GB, with the "
                 f"tail eager {td_peak:.3f} GB, K=1 {ed_peak:.3f} GB")
    del gd_fit, ed_fit, td_fit

    # ms a train step, graphed (10 steps and the refresh a replay) against eager
    opt = trainer.make_optimizer(tc)
    params = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batches = list(batching.prefetch_to_device(batching.iter_batches(
        xi_f[:DISPATCH_FIT_K * TRAIN_BATCH], xv_f[:DISPATCH_FIT_K * TRAIN_BATCH],
        y_f[:DISPATCH_FIT_K * TRAIN_BATCH], TRAIN_BATCH), dev))
    stacked = {k: torch.stack([bt[k] for bt in batches]) for k in ("xi", "xv", "y", "mask")}
    prune_kw = dict(emb_r=tc.emb_r, emb_corr=tc.emb_corr, prune_fm=True, prune_deep=True,
                    prune_r=tc.prune_r)
    multi = trainer.make_multi_step(cfg, tc, opt, prune_kw=prune_kw)

    def graphed_steps():
        multi(params, state, stacked["xi"], stacked["xv"], stacked["y"], stacked["mask"], gen,
              None, 0.01, k_real=DISPATCH_FIT_K)
        torch.cuda.synchronize()

    def eager_steps():
        for bt in batches:
            trainer.train_step(params, state, bt, cfg, tc, opt, generator=gen)
        pruning.prune_params_(params, 0.01, **prune_kw)
        torch.cuda.synchronize()
    g_ms, e_ms = in_turns(graphed_steps, eager_steps, 10)
    lines.append(f"  a train step at B={TRAIN_BATCH}, Adam + L2, dropout on, a refresh every "
                 f"{DISPATCH_FIT_K} steps included: graphed {g_ms / DISPATCH_FIT_K:.3f} ms by the "
                 f"host clock ({TRAIN_BATCH * DISPATCH_FIT_K / g_ms * 1e3:.0f} ex/s), 10 steps "
                 f"{busy(graphed_steps, 3)} | eager {e_ms / DISPATCH_FIT_K:.3f} ms "
                 f"({TRAIN_BATCH * DISPATCH_FIT_K / e_ms * 1e3:.0f} ex/s), 10 steps "
                 f"{busy(eager_steps, 3)}")

    # the fit's tail group: its real steps and the refresh, one replay against the same eager
    tail_k = TRAIN_BATCHES % DISPATCH_FIT_K
    tail_mask = stacked["mask"] * (torch.arange(DISPATCH_FIT_K, device=dev) < tail_k)[:, None]

    def graphed_tail():
        multi(params, state, stacked["xi"], stacked["xv"], stacked["y"], tail_mask, gen, None,
              0.01, k_real=tail_k)
        torch.cuda.synchronize()

    def eager_tail():
        with eager_forms():
            graphed_tail()
    gt_ms, et_ms = in_turns(graphed_tail, eager_tail, 10)
    lines.append(f"  the tail group ({tail_k} real steps of {DISPATCH_FIT_K} and the refresh): "
                 f"one replay {gt_ms:.3f} ms by the host clock, {busy(graphed_tail, 3)} | eager "
                 f"{et_ms:.3f} ms, {busy(eager_tail, 3)}")
    del multi, params, state, batches, stacked, tail_mask

    # the pipeline leg: --k-steps 8, and --k-steps 1 (a replay a step) against it eager, on the
    # same 1M rows
    tmp = tempfile.TemporaryDirectory()
    with contextlib.redirect_stdout(io.StringIO()):
        sizes = hp.generate(tmp.name, PIPE_ROWS)
    n_steps = PIPE_ROWS // TRAIN_BATCH
    digests = []        # every batch the K=1 step receives, digested on the card
    make_one = hp.make_train_step

    def digesting_train_step(*a, **kw):
        one = make_one(*a, **kw)

        def step(params, opt_state, batch, generator=None):
            digests.append(row_digests(batch["xi"], batch["xv"], batch["y"], lib=torch))
            return one(params, opt_state, batch, generator)
        return step
    legs = {}
    for name, k, form in ((f"--k-steps {PIPE_K}", PIPE_K, contextlib.nullcontext),
                          ("--k-steps 1", 1, contextlib.nullcontext),
                          ("--k-steps 1, eager", 1, eager_forms)):
        hp.make_train_step = digesting_train_step if name == "--k-steps 1" else make_one
        try:
            with form(), counting_replays() as replays:
                legs[name] = hp.card_epoch(tmp.name, sizes, TRAIN_BATCH, k, n_steps)[0], replays
        finally:
            hp.make_train_step = make_one
    check(all(res["card_steps"] == n_steps for res, _ in legs.values()), "pipeline leg steps")
    k1_replays = legs["--k-steps 1"][1]["make_train_step(forward)"]
    budget = 2 * hp.BUDGET_REPS
    check(k1_replays == n_steps + budget == len(digests) and not legs["--k-steps 1, eager"][1],
          f"--k-steps 1: {k1_replays} train-step replays for {n_steps} steps and {budget} reps")
    want = np.stack([row_digests(b["index"], b["value"], b["label"])
                     for b in ShardedBinPipeline(tmp.name).epoch_batches(TRAIN_BATCH, seed=4,
                                                                           epoch=0)])
    same_rows = np.array_equal(torch.stack(digests[:n_steps]).cpu().numpy(), want)
    check(same_rows, "--k-steps 1: the rows the card trained on differ from a second host pass")
    tmp.cleanup()
    forms = {f"--k-steps {PIPE_K}": f"graph replays, {PIPE_K} steps a replay",
             "--k-steps 1": f"graph replays, one a step: {k1_replays - budget} in the epoch, "
                            f"{budget} in the budgets; the rows trained on equal a second host "
                            f"pass: {same_rows}, their digests inside the wall",
             "--k-steps 1, eager": "eager"}
    for name, (res, _) in legs.items():
        lines.append(f"  pipeline leg, {name} ({forms[name]}): "
                     f"{res['card_steps']} steps in {res['card_wall_s']} s, "
                     f"{res['card_step_ms']} ms a step on cached input, wall_over_budget "
                     f"{res['wall_over_budget']}, {res['card_step_ms_staged']} ms a step "
                     f"staged, wall_over_staged_budget {res['wall_over_staged_budget']}, "
                     f"waiting for input {res['card_feed_s']} s")

    phase(20, f"compiled dispatch, CUDA graphs against eager on the card, "
              f"{time.perf_counter() - t_phase:.1f} s {where}")
    for line in lines:
        print(line + f" {where}")
    print(f"  dropout: {2 * DISPATCH_FIT_K} graphed steps' masks at the flagship's shapes equal "
          f"the eager steps' from the same seed: {same_masks}; fused tower launches through "
          f"the int8 Predictor's replays {graph_launches}")
    return {"launches_dispatch_path": graph_launches}


TIMER_ROWS = 4 * BATCH    # phase 21's rows through run_benchmark: four quality batches
TIMER_SINGLE = 100        # phase 21's n_single: B=1 calls of each single-example timer
TIMER_KEYS = ("batch_ms", "batch_onchip_ms", "examples_per_s", "single_example_ms",
              "single_example_onchip_ms")


class _TorchCalls(TorchFunctionMode):
    """Counts the torch functions called from Python: a forward run eagerly
    calls dozens, a graph replay none."""

    def __init__(self, calls: collections.Counter):
        super().__init__()
        self.calls = calls

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls[getattr(func, "__name__", repr(func))] += 1
        return func(*args, **(kwargs or {}))


class TimerSpy:
    """What the port's timers do inside their timed windows, for phase 21.

    A window is a run of ``profiling.timed`` (the graphed ``marginal_timeit``
    and ``scan_timeit``), in which every torch function called from Python
    is counted, or a call of ``simple_timeit`` (``run_benchmark``'s host-clock
    timers of ``Predictor.replay``), where nothing is added to the host's
    work but counters. In each: the graph replays, the forwards of a
    :meth:`counted` function run eagerly (outside a capture), and the fused
    tower's launches. :meth:`counted` also keeps the static inputs and output
    of each forward it sees captured, and each timer graph replayed in a
    window is noted once with its captured tower launches."""

    def __init__(self, int8_mlp):
        self.int8_mlp = int8_mlp
        self.windows = self.empty_windows = self.replays = self.eager = 0
        self.eager_in_windows = self.launches = 0
        self.torch_calls = collections.Counter()
        self.captured = []      # (xi, xv, logits) of each captured forward of a counted function
        self.graphs = []        # (name, batch, captured tower launches, forwards) of timer graphs

    def counted(self, fn):
        @functools.wraps(fn)
        def forward(model, xi, xv):
            out = fn(model, xi, xv)
            if torch.cuda.is_current_stream_capturing():
                self.captured.append((xi, xv, out))
            else:
                self.eager += 1
            return out
        return forward

    def window(self, run, torch_calls: bool):
        replays, eager, launches = self.replays, self.eager, self.int8_mlp.launches
        with _TorchCalls(self.torch_calls) if torch_calls else contextlib.nullcontext():
            out = run()
        self.windows += 1
        self.empty_windows += self.replays == replays
        self.eager_in_windows += self.eager - eager
        self.launches += self.int8_mlp.launches - launches
        return out

    @contextlib.contextmanager
    def spying(self, profiling, cuda_graph):
        """``profiling.timed`` runs its work as a window; ``Graphed.replay``
        counts itself and notes each timer graph."""
        timed, replay = profiling.timed, cuda_graph.Graphed.replay

        def spied_timed(run, cuda):
            return timed(lambda: self.window(run, True), cuda)

        def spied_replay(graph):
            self.replays += 1
            if graph.name.startswith(("marginal_timeit", "scan_timeit")) and \
                    not getattr(graph, "_noted", False):
                graph._noted = True
                self.graphs.append((graph.name, graph.outputs[0].shape[0],
                                    graph.captured["int8_mlp"], len(graph.outputs)))
            return replay(graph)
        profiling.timed, cuda_graph.Graphed.replay = spied_timed, spied_replay
        try:
            yield self
        finally:
            profiling.timed, cuda_graph.Graphed.replay = timed, replay


def eager_marginal(fn, model, inputs, *, k1: int = 1, k2: int = 16, reps: int = 7) -> float:
    """The eager ``marginal_timeit`` the port had before its graphs: the ``k2`` forwards
    issued eagerly between two CUDA events, the least of ``reps``, over ``k2``."""
    def run():
        for a in inputs[:k2]:
            fn(model, *a)
    run()
    return min(events_s(run) for _ in range(reps)) / k2


def eager_scan(fn, model, xi, xv, *, iters: int = 100, reps: int = 3,
               warmup: bool = True) -> float:
    """The eager ``scan_timeit`` the port had before its graphs: ``iters`` eager forwards
    between two CUDA events, the median of ``reps``, over ``iters``."""
    def run():
        for _ in range(iters):
            fn(model, xi, xv)
    if warmup:
        fn(model, xi, xv)
    return statistics.median(events_s(run) for _ in range(reps)) / iters


def events_s(run) -> float:
    """Seconds ``run`` takes on the device, between two CUDA events (for the
    eager readings: ``profiling.timed`` is the graphed timers' window, which
    :class:`TimerSpy` watches)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3


@contextlib.contextmanager
def beside_eager(module, spy: TimerSpy, Predictor, int8_mlp, eager: list):
    """``module``'s timers (``serving.benchmark``'s or
    ``tools.pruned_serving_bench``'s) each time the compiled forward, as the
    port does, and then the same call as the eager timers timed it (eager
    forwards; ``Predictor.replay`` as ``_fn``), whose reading is appended to
    ``eager`` as ``(timer, graphed, eager)``. The eager readings' tower
    launches are a yardstick's and are taken back out of the count."""
    real = {name: getattr(module, name) for name in ("marginal_timeit", "scan_timeit",
                                                     "simple_timeit") if hasattr(module, name)}
    pr10 = {"marginal_timeit": eager_marginal, "scan_timeit": eager_scan}
    replay = Predictor.replay

    def eager_replay(self, xi, xv):
        return self._fn(self._model, xi, xv)

    def both(name):
        def timer(fn, *args, **kw):
            if name == "simple_timeit":
                calls = []

                def counted_call(*a):
                    calls.append(1)
                    return fn(*a)
                replays = spy.replays
                graphed = spy.window(lambda: real[name](counted_call, *args, **kw), False)
                check(spy.replays - replays == len(calls),
                      f"simple_timeit: {spy.replays - replays} replays for {len(calls)} calls")
            else:
                graphed = real[name](fn, *args, **kw)
            launches = int8_mlp.launches
            if name == "simple_timeit":
                Predictor.replay = eager_replay
                try:
                    reading = real[name](fn, *args, **kw)
                finally:
                    Predictor.replay = replay
            else:
                reading = pr10[name](fn, *args, **kw)
            int8_mlp.launches = launches
            eager.append((name, graphed, reading))
            return graphed
        return timer
    for name in real:
        setattr(module, name, both(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def timers_phase(args, cfg, card: str) -> dict:
    """Phase 21: the port's timers time the compiled forward, as the JAX
    timers time the jitted one. ``run_benchmark`` in fp32 and dynamic int8 at
    B=8192 and ``tools.pruned_serving_bench`` at B=8192 and B=1 on the
    full-width flagship, each timer's reading beside the eager reading that
    the eager timers give for the same call. Returns the fused tower's
    launches on this path."""
    import io

    from xsdeepfwfm_deprecated_torch.compression.quantization import convert
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.serving import benchmark
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor
    from xsdeepfwfm_deprecated_torch.tools import pruned_serving_bench
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph, profiling

    where = f"[{card}]"
    t_phase = time.perf_counter()
    quiet = logging.getLogger("chip_smoke.timers")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    params_cpu = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg, device="cpu")
    xi, xv, y = make_training_rows(cfg, args.seed + 40, TIMER_ROWS)
    qm_cpu = convert(params_cpu, cfg, "dynamic")
    spy = TimerSpy(int8_mlp)
    lines = []

    # the main path of this phase: run_benchmark in fp32 and int8, then the pruned-serving arms
    int8_mlp.launches = 0
    for name, model in (("fp32", params_cpu), ("int8", qm_cpu)):
        pred = Predictor(model, cfg)
        pred._fn = spy.counted(pred._fn)
        eager, graphs = [], len(spy.graphs)
        windows, launches = spy.windows, spy.launches
        with spy.spying(profiling, cuda_graph), \
                beside_eager(benchmark, spy, Predictor, int8_mlp, eager):
            res = benchmark.run_benchmark(pred, xi, xv, y, batch_size=BATCH, logger=quiet,
                                          n_single=TIMER_SINGLE)
        check(all(np.isfinite(res[k]) and res[k] > 0 for k in TIMER_KEYS),
              f"{name}: run_benchmark's times {[res[k] for k in TIMER_KEYS]}")
        # every captured forward's logits against Predictor.logits on its batch
        far = 0.0
        for a, b, out in spy.captured:
            want = pred.logits(a.cpu().numpy(), b.cpu().numpy())
            far = max(far, float(np.abs(out.cpu().numpy() - want).max()))
        n_captured = len(spy.captured)
        spy.captured.clear()
        check(n_captured > 0 and far <= GRAPH_TOL,
              f"{name}: {n_captured} captured forwards differ from Predictor.logits by {far}")
        timer_graphs = spy.graphs[graphs:]
        fused = [g for g in timer_graphs if g[2]]
        if name == "int8":
            check(fused and all(g[1] % 512 == 0 and g[2] == g[3] for g in fused)
                  and all(g[1] % 512 for g in timer_graphs if not g[2]),
                  f"int8 timer graphs (name, batch, tower launches, forwards): {timer_graphs}")
            check(spy.launches - launches > 0, "no tower launch inside the int8 timers' windows")
            qm = pred._model
        else:
            check(not fused, f"fp32 timer graphs launched the tower: {fused}")
        # the repaired keys, graphed beside the eager timers' reading of the same call
        by_graphed = {g * 1e3: e * 1e3 for timer, g, e in eager}
        reads = {k: (v, by_graphed[v]) for k, v in res.items()
                 if k in TIMER_KEYS[:2] + TIMER_KEYS[3:] or k.startswith("component_ms/")}
        t_chip = [e for timer, g, e in eager if timer == "marginal_timeit"][-1]
        reads["examples_per_s"] = (res["examples_per_s"], BATCH / t_chip)
        lines.append(f"  run_benchmark {name} at B={BATCH}, n_single {TIMER_SINGLE}: "
                     f"{spy.windows - windows} timed windows, {len(timer_graphs)} timer graphs "
                     f"({len(fused)} with the tower inside, once a forward), {n_captured} "
                     f"captured forwards vs Predictor.logits max |diff| {far:.1e}")
        for k, (g, e) in reads.items():
            lines.append(f"    {k}: graphed {g:.4f} | eager {e:.4f}")
        del pred

    eager = []
    out, err = io.StringIO(), io.StringIO()
    with spy.spying(profiling, cuda_graph), \
            beside_eager(pruned_serving_bench, spy, Predictor, int8_mlp, eager), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        graphs = len(spy.graphs)
        rows = pruned_serving_bench.main([])
    check(len(rows) == len(eager) == 14 and all(np.isfinite(r["us_per_batch"])
                                                and r["us_per_batch"] > 0 for r in rows),
          f"pruned_serving_bench: {len(rows)} rows, {len(eager)} eager readings")
    fused = [g for g in spy.graphs[graphs:] if g[2]]
    check(len(fused) == 2 and all(g[1] == BATCH and g[2] == g[3] for g in fused),
          f"pruned_serving_bench: tower graphs {fused} (the int8 arm's two at B={BATCH})")
    path_launches = int8_mlp.launches
    tower_err = fused_tower_err(qm, cfg, xi[:BATCH], xv[:BATCH])
    check(spy.windows > 0 and spy.empty_windows == 0 and spy.eager_in_windows == 0
          and not spy.torch_calls,
          f"timed windows {spy.windows}: {spy.empty_windows} without a replay, "
          f"{spy.eager_in_windows} eager forwards, torch calls {dict(spy.torch_calls)}")
    check(tower_err <= TOL, f"int8_mlp vs its plain version: max |diff| {tower_err}")
    for r, (_, _, e) in zip(rows, eager):
        r["eager_us"] = e * 1e6
    for b in sorted({r["batch"] for r in rows}, reverse=True):
        at_b = [r for r in rows if r["batch"] == b]
        for r in at_b:
            lines.append(f"  pruned_serving_bench B={b} {r['arm']}: graphed "
                         f"{r['us_per_batch']:.1f} us | eager {r['eager_us']:.1f} us")
        for form, key in (("graphed", "us_per_batch"), ("eager", "eager_us")):
            order = " < ".join(r["arm"] for r in sorted(at_b, key=lambda r: r[key]))
            lines.append(f"  B={b} ranking, {form}: {order}")

    phase(21, f"compiled timers: every timed window replays CUDA graphs ({spy.windows} windows, "
              f"{spy.replays} replays, no eager forward and no torch call inside), "
              f"{time.perf_counter() - t_phase:.1f} s {where}")
    for line in lines:
        print(line + f" {where}")
    print(f"  fused tower: {spy.launches} launches inside the timers' windows, {path_launches} "
          f"on the phase's path; int8_mlp vs plain version on these weights max |diff| "
          f"{tower_err:.1e}")
    return {"launches_timers_path": path_launches, "max_abs_err_timers": tower_err}


PER_BATCH_STEPS = 30      # phase 22's fit: 29 full batches and a padded tail, 3 refreshes
PER_BATCH_TAIL = 1000     # real rows of the tail batch
PER_BATCH_ROUNDS = 6      # host-clock rounds of the step loop, each form in turns
PER_BATCH_EVAL = 3 * BATCH + 1234     # rows of the eval-tail check: four batches, no group


class EagerEval:
    """What ``make_eval_fn`` returns, eager: the forward of one batch."""

    def __init__(self, mcfg, forward_fn=None, **_):
        from xsdeepfwfm_deprecated_torch.models import deepfwfm
        self.mcfg, self.forward_fn = mcfg, forward_fn or deepfwfm.forward

    @torch.inference_mode()
    def __call__(self, params, xi, xv):
        return self.forward_fn(params, xi, xv, self.mcfg)


@contextlib.contextmanager
def eager_per_batch(trainer, pruning):
    """``fit``'s per-batch functions swapped for the eager functions they
    replay, for the block: ``make_train_step`` for ``train_step``,
    ``PruneRefresh`` for ``prune_params_``, ``make_eval_fn`` for the
    forward. The eager form that phase 22 holds the graphed fit to."""
    def make_train_step(mcfg, tcfg, optimizer, *, use_kd=False, forward_fn=None, mesh=None,
                        reduce=None, group=None):
        def step(params, opt_state, batch, generator=None):
            return trainer.train_step(params, opt_state, batch, mcfg, tcfg, optimizer,
                                      reduce=reduce, generator=generator,
                                      teacher_logits=batch.get("teacher"),
                                      forward_fn=forward_fn or trainer.deepfwfm.forward,
                                      group=group)
        return step

    def prune_refresh(prune_kw, mesh=None):
        return lambda params, adaptive: pruning.prune_params_(params, adaptive, **prune_kw)

    saved = trainer.make_train_step, trainer.PruneRefresh, trainer.make_eval_fn
    trainer.make_train_step, trainer.PruneRefresh, trainer.make_eval_fn = (
        make_train_step, prune_refresh, EagerEval)
    try:
        yield
    finally:
        trainer.make_train_step, trainer.PruneRefresh, trainer.make_eval_fn = saved


def per_batch_phase(args, cfg, card: str) -> dict:
    """Phase 22: the per-batch compiled dispatch, ``fit`` at its default
    ``steps_per_call=1``: each step, each refresh and each eval batch that
    fills no scanned group one CUDA graph replay, against the same fit with
    those functions eager, then ``cli.quantization`` at its defaults with a
    QAT fit and the dynamic-int8 benchmark. Returns the fused tower's
    launches on the CLI's path and its max |diff| against the plain version."""
    import collections
    import os
    import tempfile

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.cli import main_all, quantization
    from xsdeepfwfm_deprecated_torch.compression import pruning
    from xsdeepfwfm_deprecated_torch.data import batching, get_dataset
    from xsdeepfwfm_deprecated_torch.entry import flagship_train_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import int8_mlp
    from xsdeepfwfm_deprecated_torch.train import trainer
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph

    quiet = logging.getLogger("chip_smoke.per_batch")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    where = f"[{card}]"
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    lines = []
    n_rows = (PER_BATCH_STEPS - 1) * TRAIN_BATCH + PER_BATCH_TAIL
    xi, xv, y = make_training_rows(cfg, args.seed + 40, n_rows)
    tc = flagship_train_config(n_epochs=1, batch_size=TRAIN_BATCH, prune=True, warm=0,
                               sparse=0.9, random_seed=args.seed)
    n_refresh = -(-PER_BATCH_STEPS // tc.prune_interval)
    n_eval = -(-n_rows // tc.eval_batch_size)      # the train rows' eval: no group of 8 fills
    check(n_rows < trainer.EVAL_SCAN_K * tc.eval_batch_size, "phase 22's eval fills a group")

    replay, init = cuda_graph.Graphed.replay, cuda_graph.Graphed.__init__

    @contextlib.contextmanager
    def counted():
        """Replays by the graph's function, and seconds spent capturing."""
        seen = {"replays": collections.Counter(), "capture_s": 0.0}

        def counted_replay(graph):
            seen["replays"][graph.name.split("(")[0]] += 1
            return replay(graph)

        def timed_init(graph, *a, **kw):
            t0 = time.perf_counter()
            init(graph, *a, **kw)
            seen["capture_s"] += time.perf_counter() - t0
        cuda_graph.Graphed.replay, cuda_graph.Graphed.__init__ = counted_replay, timed_init
        try:
            yield seen
        finally:
            cuda_graph.Graphed.replay, cuda_graph.Graphed.__init__ = replay, init

    def fit(graphed: bool):
        """One epoch at steps_per_call=1 from seeded weights: (estimator,
        seconds, replays by function, capture seconds, GB allocated at the
        fit's peak above what was allocated when it began)."""
        est = trainer.DeepFMEstimator(cfg, tc, logger=quiet)
        est.init_params(args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        with counted() as seen, (contextlib.nullcontext() if graphed
                                 else eager_per_batch(trainer, pruning)):
            t0 = time.perf_counter()
            est.fit(xi, xv, y)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
        return est, secs, seen["replays"], seen["capture_s"], peak_gb

    # the fits in turns, graphed, eager, eager, graphed, under deterministic algorithms
    with deterministic():
        g1, e1, e2, g2 = (fit(graphed) for graphed in (True, False, False, True))
    want = {"make_train_step": PER_BATCH_STEPS, "prune_params": n_refresh, "make_eval_fn": n_eval}
    for est, secs, replays, capture_s, peak in (g1, g2):
        check(dict(replays) == want, f"graphed fit: replays {dict(replays)}, want {want}")
    for est, secs, replays, capture_s, peak in (e1, e2):
        check(not replays and capture_s == 0.0, f"eager fit: replays {dict(replays)}")
    for est, *_ in (g1, g2, e1, e2):
        check(est._step == PER_BATCH_STEPS and len(est.last_epoch_losses) == PER_BATCH_STEPS,
              f"{est._step} steps")
    ref = e1[0]
    same = {}
    for name, (est, *_) in (("graphed", g1), ("graphed again", g2), ("eager again", e2)):
        same[name] = (all(torch.equal(a, b) for a, b in zip(
            _tree.leaves((est.params, est.opt_state)), _tree.leaves((ref.params, ref.opt_state))))
            and est.last_epoch_losses == ref.last_epoch_losses
            and est.train_result == ref.train_result)
        check(same[name], f"the {name} fit differs from the eager fit under deterministic "
                          f"algorithms")
    sparsity = ref.epoch_sparsity[-1]
    check(sparsity > 0, "the fit did not prune")
    lines.append(
        f"  fit at steps_per_call=1, one epoch of {PER_BATCH_STEPS} x {TRAIN_BATCH} (the last of "
        f"{PER_BATCH_TAIL} real rows), a refresh every {tc.prune_interval} steps, dropout on, "
        f"under deterministic algorithms, graphed and eager in turns: replays a graphed fit "
        f"{dict(g1[2])}; graphed {g1[1]:.3f} and {g2[1]:.3f} s (captures {g1[3]:.3f} and "
        f"{g2[3]:.3f} s of it), eager {e1[1]:.3f} and {e2[1]:.3f} s; the fit's peak above what "
        f"was allocated before it, graphed {g1[4]:.3f} and {g2[4]:.3f} GB, eager {e1[4]:.3f} "
        f"and {e2[4]:.3f} GB; losses, "
        f"parameters, optimizer state and train AUC of every fit equal to the first eager "
        f"fit's bit for bit: {all(same.values())}; sparsity {sparsity:.4f}%, train AUC "
        f"{ref.train_result[-1]:.6f}")

    # the eval fn's batches (no scanned group): graphed against eager forwards
    est = g1[0]
    xi_e, xv_e, _ = make_training_rows(cfg, args.seed + 41, PER_BATCH_EVAL)
    with counted() as seen:
        graphed_logits = est._predict_logits(xi_e, xv_e)
    est._eval_fn = None
    with eager_per_batch(trainer, pruning):
        eager_logits = est._predict_logits(xi_e, xv_e)
    est._eval_fn = None
    n_tail = -(-PER_BATCH_EVAL // tc.eval_batch_size)
    eval_diff = float(np.abs(graphed_logits - eager_logits).max())
    check(dict(seen["replays"]) == {"make_eval_fn": n_tail},
          f"eval of {PER_BATCH_EVAL} rows: replays {dict(seen['replays'])}")
    check(graphed_logits.shape == (PER_BATCH_EVAL,) and eval_diff == 0.0,
          f"the graphed eval batches differ from eager forwards by {eval_diff}")
    lines.append(f"  _predict_logits of {PER_BATCH_EVAL:,} rows ({n_tail} batches of "
                 f"{tc.eval_batch_size}, the last padded): {n_tail} eval-fn replays, against "
                 f"eager forwards max |diff| {eval_diff:.1e}")
    del g1, g2, e1, e2, ref, est

    # ms a step at B=2048: the fit's loop (30 steps, 3 refreshes) and the steps alone
    opt = trainer.make_optimizer(tc)
    params = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), cfg)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batches = list(batching.prefetch_to_device(batching.iter_batches(xi, xv, y, TRAIN_BATCH), dev))
    prune_kw = dict(emb_r=tc.emb_r, emb_corr=tc.emb_corr, prune_fm=True, prune_deep=True,
                    prune_r=tc.prune_r)
    refresh_at = {i: tc.adaptive_sparse(i + 1) for i in range(PER_BATCH_STEPS)
                  if i % tc.prune_interval == tc.prune_interval - 1 or i == PER_BATCH_STEPS - 1}
    forms = {"graphed": (trainer.make_train_step(cfg, tc, opt), trainer.PruneRefresh(prune_kw))}
    with eager_per_batch(trainer, pruning):
        forms["eager"] = (trainer.make_train_step(cfg, tc, opt), trainer.PruneRefresh(prune_kw))

    def loop(form: str, prune: bool):
        step, refresh = forms[form]

        def run():
            for i, batch in enumerate(batches):
                step(params, state, batch, gen)
                if prune and i in refresh_at:
                    refresh(params, refresh_at[i])
            torch.cuda.synchronize()
        return run

    timing = {}
    for prune in (True, False):
        runs = {form: loop(form, prune) for form in forms}
        for run in runs.values():
            run()                  # the graphed form captures here
        per_step = {form: [] for form in forms}
        for r in range(PER_BATCH_ROUNDS):
            for form in (("graphed", "eager") if r % 2 == 0 else ("eager", "graphed")):
                t0 = time.perf_counter()
                runs[form]()
                per_step[form].append((time.perf_counter() - t0) * 1e3 / PER_BATCH_STEPS)
        for form, run in runs.items():
            wall, dev_ms, _ = profile_top(run, calls=2, top=1)
            timing[(form, prune)] = (per_step[form], dev_ms / PER_BATCH_STEPS,
                                     dev_ms / wall)
    for prune in (True, False):
        what = (f"a step of the fit's loop ({PER_BATCH_STEPS} steps, {len(refresh_at)} refreshes)"
                if prune else "a step alone")
        parts = []
        for form in forms:
            ms, dev_step, share = timing[(form, prune)]
            parts.append(f"{form} {statistics.median(ms):.3f} ms by the host clock (median of "
                         f"{PER_BATCH_ROUNDS}, {min(ms):.3f} to {max(ms):.3f}; "
                         f"{TRAIN_BATCH / statistics.median(ms) * 1e3:.0f} ex/s), device "
                         f"{dev_step:.4f} ms a step, {share:.0%} busy under the profiler")
        lines.append(f"  {what}, B={TRAIN_BATCH}, Adam + L2, dropout on: " + " | ".join(parts))
    check(all(np.isfinite(ms).all() for ms, _, _ in timing.values()), "a step time")
    del forms, params, state, batches

    # cli.quantization at its defaults (steps_per_call 1, 8 epochs) on tiny-criteo: a QAT fit
    # through the graphs and the dynamic-int8 benchmark through the fused tower
    tmp = tempfile.TemporaryDirectory()
    home = os.getcwd()
    os.chdir(tmp.name)          # the CLIs write ./saved_models and ./logs
    try:
        _, train_rows, _, test_rows = get_dataset("tiny-criteo")
        with counted() as seen_fit:
            t0 = time.perf_counter()
            teacher = main_all.main(["-dataset", "tiny-criteo", "-n_epochs", "1",
                                     *FLAGSHIP_FLAGS])
            main_s = time.perf_counter() - t0
        quant_flags = ["-dataset", "tiny-criteo", "-save_model_path", teacher.save_model_name,
                       "-dynamic_quantization", "1", "-quantization_aware", "1", *FLAGSHIP_FLAGS]
        int8_mlp.launches = 0
        with counted() as seen_cli:
            t0 = time.perf_counter()
            q = quantization.main(quant_flags)
            quant_s = time.perf_counter() - t0
        cli_launches = int8_mlp.launches
        with counted() as seen_eager, eager_per_batch(trainer, pruning):   # beside it, eager
            t0 = time.perf_counter()
            q_eager = quantization.main(quant_flags)
            eager_quant_s = time.perf_counter() - t0
        check(not seen_eager["replays"]["make_train_step"] and q_eager["qat"]["estimator"]._step
              == q["qat"]["estimator"]._step, "the eager cli.quantization's fit")
        qat = q["qat"]["estimator"]
        steps_epoch = -(-train_rows["label"].shape[0] // TRAIN_BATCH)
        check(qat.tcfg.steps_per_call == 1 and qat._step == qat.tcfg.n_epochs * steps_epoch,
              f"the QAT fit: steps_per_call {qat.tcfg.steps_per_call}, {qat._step} steps")
        for what, seen, steps in (("cli.main_all", seen_fit, steps_epoch),
                                  ("cli.quantization's QAT fit", seen_cli, qat._step)):
            check(seen["replays"]["make_train_step"] == steps and seen["replays"]["make_eval_fn"],
                  f"{what}: replays {dict(seen['replays'])} for {steps} steps")
        # with -quantization_aware 1 the loaded model is benchmarked in its int8 QAT form too
        check(q["dynamic"]["tower_launches"] > 0 and q["qat"]["tower_launches"] > 0,
              f"fused tower launches: { {k: v['tower_launches'] for k, v in q.items()} }")
        xi_t = np.asarray(test_rows["index"][:BATCH], np.int32)
        xv_t = np.asarray(test_rows["value"][:BATCH], np.float32)
        tower_err = fused_tower_err(q["dynamic"]["model"], teacher.mcfg, xi_t, xv_t)
        check(tower_err == 0.0, f"int8_mlp vs plain version on cli.quantization's dynamic model: "
                                f"{tower_err}")
        bench = {k: v["benchmark"] for k, v in q.items()}
        lines.append(
            f"  cli.main_all -n_epochs 1 on tiny-criteo {main_s:.1f} s ({steps_epoch} steps: "
            f"replays {dict(seen_fit['replays'])}, captures {seen_fit['capture_s']:.2f} s); "
            f"cli.quantization -dynamic_quantization 1 -quantization_aware 1 at its defaults "
            f"{quant_s:.1f} s (with the per-batch functions eager {eager_quant_s:.1f} s): QAT "
            f"fit of {qat._step} steps, replays {dict(seen_cli['replays'])}, captures "
            f"{seen_cli['capture_s']:.2f} s; QAT test AUC eager "
            f"{q_eager['qat']['benchmark']['auc']:.6f}; test AUC "
            f"original {bench['original']['auc']:.6f}, dynamic {bench['dynamic']['auc']:.6f}, "
            f"QAT {bench['qat']['auc']:.6f}; fused tower launches "
            f"{ {k: v['tower_launches'] for k, v in q.items()} }, int8_mlp vs plain version on "
            f"the dynamic model max |diff| {tower_err:.1e}")
    finally:
        os.chdir(home)
        tmp.cleanup()

    phase(22, f"per-batch compiled dispatch: fit at steps_per_call=1 as graph replays against "
              f"eager, {time.perf_counter() - t_phase:.1f} s {where}")
    for line in lines:
        print(line + f" {where}")
    return {"launches_per_batch_path": cli_launches, "max_abs_err_per_batch": tower_err}


HASH_ROWS = 24 * 1024       # phase 23's training rows: 24 steps an epoch at the default B=1024
HASH_TEST_ROWS = 16_384
HASH_EPOCHS = 2
HASH_AUC_GAP = 1e-5         # the card's test AUC against the CPU port's


def last_forms_phase(args, cfg, card: str) -> None:
    """Phase 23: the last compiled forms. ``HashMLPBaseline`` at its default
    width (``hash_dim`` 2048, hidden (256, 128), B=1024) on seeded rows at the
    full-Criteo cardinalities: graphed and eager fits in turns under
    deterministic algorithms, equal bit for bit; one replay a step, counted;
    the test AUC against the CPU port's fit; ms a step graphed and eager, by
    the host clock and by device time."""
    import dataclasses

    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.config import TrainConfig
    from xsdeepfwfm_deprecated_torch.models import hash_mlp_baseline as hm
    from xsdeepfwfm_deprecated_torch.utils import cuda_graph

    quiet = logging.getLogger("chip_smoke.last_forms")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    where = f"[{card}]"
    t_phase = time.perf_counter()
    xi, xv, y = make_training_rows(cfg, args.seed + 50, HASH_ROWS + HASH_TEST_ROWS)
    train, test = slice(0, HASH_ROWS), slice(HASH_ROWS, None)
    tc = TrainConfig(n_epochs=HASH_EPOCHS, batch_size=1024, learning_rate=1e-3,
                     random_seed=args.seed)
    steps = HASH_EPOCHS * (HASH_ROWS // tc.batch_size)

    def fit(graphed: bool):
        base = hm.HashMLPBaseline(train_cfg=tc, logger=quiet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if graphed else eager_forms()), \
                counting_replays() as replays:
            base.fit(xi[train], xv[train], y[train])
        torch.cuda.synchronize()
        return base, time.perf_counter() - t0, replays[hm_step_name]

    hm_step_name = "HashMLPBaseline.fit step"
    fits = []
    with deterministic():
        for graphed in (True, False, True, False):
            fits.append((graphed,) + fit(graphed))
    ref = fits[0][1]
    leaves = lambda b: _tree.leaves(b.params)      # noqa: E731
    same = all(all(torch.equal(a, w) for a, w in zip(leaves(b), leaves(ref)))
               and b.last_epoch_losses == ref.last_epoch_losses for _, b, _, _ in fits)
    replays = [(g, n) for g, _, _, n in fits]
    check(same, "graphed and eager hash-MLP fits differ")
    check(all(n == (steps if g else 0) for g, n in replays),
          f"hash-MLP fit replays {replays} for {steps} steps a graphed fit")
    cpu = hm.HashMLPBaseline(train_cfg=tc, logger=quiet, device="cpu")
    cpu.fit(xi[train], xv[train], y[train])
    auc_card = ref.evaluate(xi[test], xv[test], y[test])[0]
    auc_cpu = cpu.evaluate(xi[test], xv[test], y[test])[0]
    check(abs(auc_card - auc_cpu) <= HASH_AUC_GAP,
          f"hash-MLP test AUC {auc_card} on the card, {auc_cpu} on the CPU")

    # ms a step: the fit's step function, graphed as fit graphs it, against it eager
    dev = torch.device("cuda")
    params = hm.init_params(torch.Generator().manual_seed(args.seed), 13 + ref.hash_dim,
                            ref.hidden, device=dev)
    opt = hm.Optimizer(dataclasses.replace(tc, optimizer_type="adam", weight_decay=0.0))
    state = opt.init(params)
    x = torch.from_numpy(ref._featurize(xi[:tc.batch_size], xv[:tc.batch_size])).to(dev)
    yb = torch.from_numpy(y[:tc.batch_size]).to(dev)
    step = cuda_graph.Compiled(lambda p, s, a, b: hm.train_step(p, s, opt, a, b), hm_step_name,
                               writes_state=True)

    def graphed_step():     # the first call, in in_turns' warm-up, captures
        step((params, state), {"a": x, "b": yb})
        torch.cuda.synchronize()

    def eager_step():
        hm.train_step(params, state, opt, x, yb)
        torch.cuda.synchronize()
    g_ms, e_ms = in_turns(graphed_step, eager_step, 50)
    g_busy, e_busy = busy(graphed_step, 20), busy(eager_step, 20)
    del step, params, state
    phase(23, f"the last compiled forms: HashMLPBaseline at hash_dim {ref.hash_dim}, hidden "
              f"{tuple(ref.hidden)}, B={tc.batch_size}, {time.perf_counter() - t_phase:.1f} s "
              f"{where}")
    print(f"  fits of {HASH_EPOCHS} epochs of {HASH_ROWS // tc.batch_size} steps on {HASH_ROWS:,} "
          f"seeded rows at the full-Criteo cardinalities, under deterministic algorithms, "
          f"graphed and eager in turns: "
          + ", ".join(f"{'graphed' if g else 'eager'} {secs:.3f} s ({n} replays)"
                      for g, _, secs, n in fits)
          + f"; parameters and losses equal bit for bit: {same} {where}")
    print(f"  test AUC on {HASH_TEST_ROWS:,} rows: card {auc_card:.6f}, CPU port {auc_cpu:.6f} "
          f"(|diff| {abs(auc_card - auc_cpu):.1e}, at most {HASH_AUC_GAP}) {where}")
    print(f"  a step at B={tc.batch_size} (forward, BCE, autograd.grad, Adam): graphed "
          f"{g_ms:.3f} ms by the host clock, {g_busy} | eager {e_ms:.3f} ms, {e_busy} {where}")


def optimizer_phase(args, card: str) -> dict:
    """Phase 24: the fused Adam kernel alone at the leaves of the benchmark's
    two configurations, with their L2: one step against the plain version
    from equal states, bit for bit, then the device time of a CUDA graph of
    20 calls (median of 10) beside the bound, the plain version and
    ``torch._fused_adam_``. Returns the kernels line's entries."""
    from port_bench.program import model_config
    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.fused_adam import adam_reference, fused_adam
    from xsdeepfwfm_deprecated_torch.train.trainer import _TABLE_GROUPS

    where = f"[{card}]"
    dev = torch.device("cuda")
    out = {}
    for name in ("deepfwfm_criteo", "deepfwfm_avazu"):
        conf = json.loads((BENCH_CONFIGS / f"{name}.json").read_text())
        named = list(_tree.named_leaves(deepfwfm.init_params(
            torch.Generator().manual_seed(args.seed), model_config(conf), device=dev)))
        gen = torch.Generator(device=dev).manual_seed(args.seed + 24)
        p = [t for _, t in named]
        g = [torch.randn(t.shape, generator=gen, device=dev) * 1e-2 for t in p]
        mu = [torch.randn(t.shape, generator=gen, device=dev) * 1e-3 for t in p]
        nu = [torch.rand(t.shape, generator=gen, device=dev) * 1e-6 for t in p]
        flush = [n.split("/")[0] in _TABLE_GROUPS for n, _ in named]
        count = torch.full((), 7, dtype=torch.int32, device=dev)
        bc1, bc2 = 1 - torch.pow(0.9, count), 1 - torch.pow(0.999, count)
        kw = dict(lr=conf["learning_rate"], wd=conf["weight_decay"], b1=0.9, b2=0.999, eps=1e-8)
        n_values = sum(t.numel() for t in p)

        clone = lambda ts: [t.clone() for t in ts]   # noqa: E731
        got, want = (clone(p), clone(mu), clone(nu)), (clone(p), clone(mu), clone(nu))
        fused_adam(got[0], g, got[1], got[2], flush, bc1, bc2, **kw)
        adam_reference(want[0], g, want[1], want[2], flush, bc1, bc2, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for x, y in zip(got, want) for a, b in zip(x, y))
        check(same, f"{name}: the fused Adam step differs from the plain version")
        del got, want

        kernel_ms = graph_ms(lambda: fused_adam(p, g, mu, nu, flush, bc1, bc2, **kw))
        plain_ms = graph_ms(lambda: adam_reference(p, g, mu, nu, flush, bc1, bc2, **kw))
        steps = [torch.full((), 7.0, device=dev) for _ in p]
        library_ms = graph_ms(lambda: torch._fused_adam_(
            p, g, mu, nu, [], steps, lr=kw["lr"], beta1=0.9, beta2=0.999,
            weight_decay=kw["wd"], eps=1e-8, amsgrad=False, maximize=False))
        bound_ms = 28 * n_values / HBM_BYTES_PER_S * 1e3
        phase(24, f"fused Adam at {name}'s {len(p)} leaves, {n_values:,} values: one step "
                  f"equal to the plain version bit for bit: {same} {where}")
        print(f"  fused_adam kernel {kernel_ms:.4f} ms | bound {bound_ms:.4f} ms (28 B a value "
              f"at 3.35 TB/s; {100 * bound_ms / kernel_ms:.1f}% of it, "
              f"{28 * n_values / kernel_ms / 1e9:.3f} TB/s) | plain _foreach {plain_ms:.4f} ms | "
              f"torch._fused_adam_ {library_ms:.4f} ms (yardstick) {where}")
        out[name] = {"kernel_ms": round(kernel_ms, 4), "bound_ms": round(bound_ms, 4),
                     "plain_ms": round(plain_ms, 4), "library_ms": round(library_ms, 4)}
        del p, g, mu, nu, steps
        torch.cuda.empty_cache()
    return {"device_ms_by_config": out}


def refresh_phase(args, card: str) -> dict:
    """Phase 25: the prune refresh alone at the Criteo configuration's leaves,
    with the benchmark's keyword arguments: the kernel's route against the torch
    path from equal trees, bit for bit, 7 launches a refresh; then the device time
    of a CUDA graph of 20 calls (median of 10) beside the bound, the torch path's
    (the yardstick), a ``PruneRefresh`` replay between CUDA events, and the
    refresh's top device operations. Returns the kernels line's entries."""
    from port_bench import roofline
    from port_bench.program import model_config
    from xsdeepfwfm_deprecated_torch import _tree
    from xsdeepfwfm_deprecated_torch.compression import pruning
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.prune_search import LAUNCHES, prune_search
    from xsdeepfwfm_deprecated_torch.train.trainer import PruneRefresh

    where = f"[{card}]"
    dev = torch.device("cuda")
    conf = json.loads((BENCH_CONFIGS / "deepfwfm_criteo.json").read_text())
    params = deepfwfm.init_params(torch.Generator().manual_seed(args.seed), model_config(conf),
                                  device=dev)
    dense = params["emb2"]["dense"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    dense.masked_fill_(torch.rand(dense.shape, generator=gen, device=dev) < 0.4, 0)
    dense[200_000:500_000] *= 1e-29
    kw = {k: conf[k] for k in ("emb_r", "emb_corr", "prune_fm", "prune_deep", "prune_r")}
    target = torch.full((), 0.5, device=dev)
    launches = LAUNCHES

    @contextlib.contextmanager
    def torch_path():
        takes = pruning._kernel_takes
        pruning._kernel_takes = lambda leaf: False
        try:
            yield
        finally:
            pruning._kernel_takes = takes

    clone = lambda: _tree.tree_map(torch.clone, params)   # noqa: E731
    got, want = clone(), clone()
    before = prune_search.launches
    pruning.prune_params_(got, target, **kw)
    check(prune_search.launches == before + launches,
          f"a refresh made {prune_search.launches - before} prune_search launches")
    with torch_path():
        pruning.prune_params_(want, target, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(_tree.leaves(got), _tree.leaves(want)))
    check(same, "the kernel's refresh differs from the torch path's")
    del got, want

    kernel_ms = graph_ms(lambda: pruning.prune_params_(params, target, **kw))
    with torch_path():
        plain_ms = graph_ms(lambda: pruning.prune_params_(params, target, **kw))
    refresh = PruneRefresh(kw)
    event_ms = cuda_ms(lambda: refresh(params, 0.5), 20, warmup=2)
    _, busy_ms, top = profile_top(lambda: refresh(params, 0.5), calls=10)
    bound_ms = roofline.refresh_least_seconds(conf) * 1e3
    phase(25, f"prune refresh at deepfwfm_criteo's {roofline.pruned_values(conf):,} pruned "
              f"values: the kernel's route equal to the torch path bit for bit: {same}, "
              f"{launches} launches a refresh {where}")
    print(f"  prune_search route {kernel_ms:.4f} ms | bound {bound_ms:.4f} ms (2 x 4 B a value "
          f"at 3.35 TB/s; {100 * bound_ms / kernel_ms:.2f}% of it) | torch path {plain_ms:.4f} "
          f"ms (yardstick) | PruneRefresh replay {event_ms:.4f} ms between events, "
          f"{busy_ms:.4f} ms busy {where}")
    for key, ms, count in top:
        print(f"    {ms:8.4f} ms  x{count:g}  {key}")
    check(not any("ReduceOp_long" in key or "count_nonzero" in key for key, _, _ in top),
          "a count pass in the refresh's top operations")
    del params, refresh
    torch.cuda.empty_cache()
    return {"kernel_ms": round(kernel_ms, 4), "bound_ms": round(bound_ms, 4),
            "plain_ms": round(plain_ms, 4), "event_ms": round(event_ms, 4),
            "launches_per_refresh": launches}


def cin_phase(args, card: str) -> dict:
    """Phase 26: xDeepFM's CIN layer kernels at the cell's shapes and at ragged ones
    against the plain version, two runs bit-equal, their device time (a CUDA graph of
    20 calls, median of 10) beside the bound, the plain version and cuBLAS's
    ``z @ W^T``; then the cell's training step through ``make_train_step``: launches a
    replay, peak memory, ms a step and its top device operations. Returns the
    kernels line's entries."""
    from port_bench import generator, program, xdeepfm
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.ops.cuda import cin as cin_ops
    from xsdeepfwfm_deprecated_torch.train.trainer import make_optimizer, make_train_step

    where = f"[{card}]"
    dev = torch.device("cuda")
    conf = json.loads((BENCH_CONFIGS / "xdeepfm_criteo.json").read_text())
    traffic = json.loads((BENCH_TRAFFIC / "train_xdeepfm_b4096.json").read_text())
    m, maps, b = conf["field_size"], list(conf["cin_layers"]), traffic["batch"]
    rows = b * conf["embedding_size"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 26)

    def operands(hp, fields, h, n, first=False):
        x0t = torch.randn((fields, n), generator=gen, device=dev) * 0.5
        xk1t = x0t if first else torch.randn((hp, n), generator=gen, device=dev)
        w = torch.randn((h, hp * fields), generator=gen, device=dev) * (2.0 / (hp * fields + h)) ** 0.5
        g = torch.randn((h, n), generator=gen, device=dev)
        return xk1t, x0t, w, g

    def both(xk1t, x0t, w, g):
        """(kernel, plain): each the output and the three gradients, as layer k sees them."""
        kernel = (cin_ops._forward(xk1t, x0t, w), *cin_ops._grads(g, xk1t, x0t, w))
        plain = (cin_ops.cin_layer_reference(xk1t, x0t, w),
                 *cin_ops.cin_layer_grads_reference(g, xk1t, x0t, w))
        return kernel, plain

    def gap(got, want) -> float:
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    cell = [(m, m, maps[0], rows, True), (maps[0], m, maps[1], rows, False)]
    worst = {}
    for hp, fields, h, n, first in cell + [(*s, False) for s in CIN_RAGGED]:
        ops = operands(hp, fields, h, n, first)
        kernel, plain = both(*ops)
        torch.cuda.synchronize()
        gaps = [gap(a, p) for a, p in zip(kernel, plain)]
        key = f"{hp}x{fields}->{h} rows {n}" + (" (layer 1)" if first else "")
        worst[key] = max(gaps)
        check(max(gaps) <= CIN_TOL, f"CIN {key}: the kernels part from the plain version by "
                                    f"{gaps} (output, dX^(k-1), dX0, dW) of the largest value")
        if (hp, h, n) == (maps[0], maps[1], rows):
            again = both(*ops)[0]
            same = all(torch.equal(a, c) for a, c in zip(kernel, again))
            check(same, "CIN: two runs of the kernels differ")
        del ops, kernel, plain
    phase(26, f"CIN layer kernels against the plain version: worst gap (of the largest value, "
              f"output and three gradients) " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; at most {CIN_TOL}; two runs bit-equal: {same} {where}")

    times = {}
    for hp, fields, h, n, first in cell:
        xk1t, x0t, w, g = operands(hp, fields, h, n, first)
        flop = 2.0 * n * hp * fields * h
        z = (xk1t.T.unsqueeze(-1) * x0t.T.unsqueeze(-2)).reshape(n, -1)
        t = {"forward_ms": graph_ms(lambda: cin_ops._forward(xk1t, x0t, w)),
             "backward_ms": graph_ms(lambda: cin_ops._grads(g, xk1t, x0t, w)),
             "plain_forward_ms": graph_ms(lambda: cin_ops.cin_layer_reference(xk1t, x0t, w)),
             "plain_backward_ms": graph_ms(
                 lambda: cin_ops.cin_layer_grads_reference(g, xk1t, x0t, w)),
             "library_ms": graph_ms(lambda: z @ w.T),
             "bound_forward_ms": flop / FP32_FLOP_PER_S * 1e3,
             "bound_backward_ms": 2 * flop / FP32_FLOP_PER_S * 1e3}
        times["layer 1" if first else "layers 2, 3"] = t
        print(f"  CIN {hp}x{fields}->{h} at {n:,} rows: forward {t['forward_ms']:.4f} ms (bound "
              f"{t['bound_forward_ms']:.4f}, {100 * t['bound_forward_ms'] / t['forward_ms']:.1f}% "
              f"of the fp32 peak) | backward {t['backward_ms']:.4f} ms (bound "
              f"{t['bound_backward_ms']:.4f}, "
              f"{100 * t['bound_backward_ms'] / t['backward_ms']:.1f}%) | plain {t['plain_forward_ms']:.4f} "
              f"and {t['plain_backward_ms']:.4f} ms | cuBLAS z @ W^T {t['library_ms']:.4f} ms "
              f"(yardstick) {where}")
        del xk1t, x0t, w, g, z
        torch.cuda.empty_cache()
    whole = {k: times["layer 1"][k] + (len(maps) - 1) * times["layers 2, 3"][k]
             for k in times["layer 1"]}
    print(f"  the cell's CIN ({len(maps)} layers): forward {whole['forward_ms']:.4f} ms, backward "
          f"{whole['backward_ms']:.4f} ms, bound {whole['bound_forward_ms']:.4f} and "
          f"{whole['bound_backward_ms']:.4f} ms, plain {whole['plain_forward_ms']:.4f} and "
          f"{whole['plain_backward_ms']:.4f} ms, cuBLAS forward GEMMs {whole['library_ms']:.4f} ms "
          f"{where}")

    # the cell's training step: make_train_step's replays, at the cell's weights and rows
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mcfg, tcfg = xdeepfm.model_config(conf), xdeepfm.train_config(conf, traffic)
    params = program.params(mcfg, xdeepfm.make(conf, args.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    xi, xv, y = generator.sample_rows(conf, traffic, 8 * b, args.seed, dev)
    batches = list(batching.prefetch_to_device(batching.iter_batches(xi, xv, y, b), dev))
    drop = torch.Generator(device=dev).manual_seed(args.seed)
    losses = [step(params, opt_state, batches[0], drop)]          # the capture
    per_step = []
    for batch in batches[1:]:
        before = cin_ops.cin.launches
        losses.append(step(params, opt_state, batch, drop))
        per_step.append(cin_ops.cin.launches - before)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    layer_shapes = list(zip([m] + maps[:-1], maps))
    want = len(maps) + sum(
        2 + (cin_ops.slices(-(-hp * m // cin_ops.ROWS) * -(-h // cin_ops.COLS), rows,
                            torch.cuda.get_device_properties(dev).multi_processor_count)[0] > 1)
        for hp, h in layer_shapes)
    check(per_step == [want] * len(per_step), f"CIN launches a train step {per_step}, not {want}")
    z_bytes = 4 * rows * maps[0] * m
    check(peak < z_bytes, f"the train step's peak memory {peak} B is not below one "
                          f"(B*D, H*m) product, {z_bytes} B")
    check(all(bool(torch.isfinite(l)) for l in losses), "a non-finite loss")
    i = [0]

    def one():
        i[0] = (i[0] + 1) % len(batches)
        step(params, opt_state, batches[i[0]], drop)
    step_ms = cuda_ms(one, 20, warmup=3)
    _, busy_ms, top = profile_top(one, calls=10)
    print(f"  xDeepFM train step at B={b} through make_train_step: {per_step[0]} CIN launches a "
          f"replay ({len(per_step)} replays), peak memory {peak:,} B from the weights up (one "
          f"(B*D, H*m) product: {z_bytes:,} B), {step_ms:.3f} ms a step between events, "
          f"{1e3 * b / step_ms:,.0f} examples/s, {busy_ms:.3f} ms busy {where}")
    for key, ms, count in top:
        print(f"    {ms:8.4f} ms  x{count:g}  {key}")
    del params, opt_state, step, batches
    torch.cuda.empty_cache()
    return {"device_ms_by_layer": {k: {n: round(v, 4) for n, v in t.items()}
                                   for k, t in times.items()},
            "device_ms_cell": {n: round(v, 4) for n, v in whole.items()},
            "worst_gap": max(worst.values()), "launches_per_train_step": per_step[0],
            "train_step_ms": round(step_ms, 3), "train_step_peak_bytes": peak}


def bag_update_phase(args, card: str) -> dict:
    """Phase 27: DLRM-DCNv2's sparse Adagrad kernel at the cell's shapes, on a batch of the
    cell's traffic and a full-size table and accumulator: the kernel against the plain
    version of its order (bit for bit, on compact copies of the rows the batch reads) over
    two steps, against itself from one state, and against the torch form within the cell's
    limits; rows off the batch untouched; device time (a CUDA graph of 20 calls, median of
    10) beside the bound and the torch form's; then the cell's training step through
    ``make_train_step``: launches a replay, ms a step and its top device operations.
    Returns the kernels line's entries."""
    from port_bench import dlrm, dlrm_roofline
    from port_bench.reference import dlrm_dcnv2 as ref
    from xsdeepfwfm_deprecated_torch.data import batching
    from xsdeepfwfm_deprecated_torch.ops import embedding as emb_ops
    from xsdeepfwfm_deprecated_torch.ops.cuda import bag_adagrad as ba
    from xsdeepfwfm_deprecated_torch.train.trainer import (ADAGRAD_EPS, make_optimizer,
                                                           make_train_step)

    where = f"[{card}]"
    dev = torch.device("cuda")
    conf = json.loads((BENCH_CONFIGS / "dlrm_dcnv2_criteo1tb.json").read_text())
    traffic = json.loads((BENCH_TRAFFIC / "train_dlrm_b8192.json").read_text())
    limits = json.loads((BENCH_LIMITS / "criteo1tb_dlrm_dcnv2_train_b8192.json").read_text())
    b, lr, width = traffic["batch"], conf["learning_rate"], conf["embedding_size"]
    mcfg = dlrm.model_config(conf)
    spec = emb_ops.bag_spec(mcfg.feature_sizes, mcfg.numerical, mcfg.bag_sizes)
    cols = spec.column_field
    xi, _, _ = dlrm.sample_rows(conf, traffic, b, args.seed + 27, dev)
    rows = ref.packed_rows(conf, torch.from_numpy(xi).to(dev))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 27)
    grads = [torch.randn((b, len(spec.bag_sizes), width), generator=gen, device=dev) * 1e-2
             for _ in range(3)]
    table = torch.empty((dlrm.table_rows(conf), width), device=dev).normal_(generator=gen)
    table.mul_(dlrm.TABLE_SCALE)
    acc = torch.zeros_like(table)
    touched = torch.unique(rows)
    compact = torch.searchsorted(touched, rows)
    distinct = touched.numel()

    def checksum():
        return [int(t.view(torch.int32).sum(dtype=torch.int64)) for t in (table, acc)]

    def bits(a, b_):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b_))

    def kernel(grad, count):
        ba.bag_adagrad(table, acc, rows, grad, cols, lr, ADAGRAD_EPS, count)
        return table[touched].clone(), acc[touched].clone(), count

    def on_compact(fn, state, grad):
        t, a = state[0].clone(), state[1].clone()
        count = torch.zeros((), dtype=torch.int64, device=dev)
        fn(t, a, grad, count)
        return t, a, count

    def reference(t, a, grad, count):
        ba.bag_adagrad_reference(t, a, compact, grad, cols, lr, ADAGRAD_EPS, count)

    def torch_form(t, a, grad, count):
        emb_ops.bag_adagrad_torch(t, a, emb_ops.BagGrad(compact, grad, spec), lr, ADAGRAD_EPS,
                                  count)

    before_sums = checksum()
    w0 = (table[touched].clone(), acc[touched].clone())
    before = ba.bag_adagrad.launches
    k1 = kernel(grads[0], torch.zeros((), dtype=torch.int64, device=dev))
    check(ba.bag_adagrad.launches == before + ba.LAUNCHES,
          f"a step made {ba.bag_adagrad.launches - before} bag_adagrad launches")
    r1 = on_compact(reference, w0, grads[0])
    t1 = on_compact(torch_form, w0, grads[0])
    k2 = kernel(grads[1], torch.zeros((), dtype=torch.int64, device=dev))
    r2 = on_compact(reference, k1, grads[1])
    table[touched], acc[touched] = k1[0], k1[1]
    k2_again = kernel(grads[1], torch.zeros((), dtype=torch.int64, device=dev))
    table[touched], acc[touched] = w0[0], w0[1]
    torch.cuda.synchronize()
    same_ref = bits(k1[:2], r1[:2]) and bits(k2[:2], r2[:2])
    same_runs = bits(k2[:2], k2_again[:2])
    counts = [int(x[2]) for x in (k1, r1, t1, k2, r2, k2_again)]
    check(same_ref, "the kernel differs from the plain version of its order")
    check(same_runs, "two runs of the kernel from one state differ")
    check(counts == [distinct] * len(counts), f"rows updated {counts}, distinct {distinct}")
    check(checksum() == before_sums, "a row off the batch changed")

    def gap(got, want):
        return float((got - want).norm() / want.norm())
    grad_gap = gap(k1[1].sqrt(), t1[1].sqrt())            # the accumulator holds g² after a step
    change_gap = gap(k1[0] - w0[0], t1[0] - w0[0])
    check(grad_gap <= limits["grad_gap"] and change_gap <= limits["median_change_gap"],
          f"against the torch form: gradient gap {grad_gap:.3e}, change gap {change_gap:.3e}")
    phase(27, f"DLRM-DCNv2's bags' Adagrad at the cell's shapes ({rows.numel():,} ids, "
              f"{distinct:,} distinct rows of {table.shape[0]:,} at E={width}): equal to the "
              f"plain version of its order bit for bit over two steps: {same_ref}; two runs "
              f"bit-equal: {same_runs}; against the torch form gradient gap {grad_gap:.2e} "
              f"(limit {limits['grad_gap']}), change gap {change_gap:.2e} (limit "
              f"{limits['median_change_gap']}); rows updated {counts[0]:,} (rows_gap 0); rows "
              f"off the batch untouched {where}")
    del k1, k2, k2_again, r1, r2, t1, w0

    count = torch.zeros((), dtype=torch.int64, device=dev)
    kernel_ms = graph_ms(lambda: ba.bag_adagrad(table, acc, rows, grads[2], cols, lr,
                                                ADAGRAD_EPS, count))
    bag_grad = emb_ops.BagGrad(rows, grads[2], spec)
    torch_ms = graph_ms(lambda: emb_ops.bag_adagrad_torch(table, acc, bag_grad, lr, ADAGRAD_EPS,
                                                          count))
    bound_ms = dlrm_roofline.update_least_seconds(conf, b, distinct) * 1e3
    print(f"  bag_adagrad kernel {kernel_ms:.4f} ms | bound {bound_ms:.4f} ms "
          f"({dlrm_roofline.update_bytes(conf, b, distinct):,.0f} B at 3.35 TB/s; "
          f"{100 * bound_ms / kernel_ms:.1f}% of it) | torch form {torch_ms:.4f} ms {where}")
    del table, acc, grads, bag_grad
    torch.cuda.empty_cache()

    # the cell's training step: make_train_step's replays, at the cell's weights and rows
    tcfg = dlrm.train_config(conf, traffic)
    params = dlrm.params(mcfg, dlrm.make(conf, args.seed, dev))
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    step = make_train_step(mcfg, tcfg, optimizer)
    xi, xv, y = dlrm.sample_rows(conf, traffic, 6 * b, args.seed, dev)
    batches = list(batching.prefetch_to_device(batching.iter_batches(xi, xv, y, b), dev))
    torch.cuda.empty_cache()
    losses = [step(params, opt_state, batches[0])]                 # the capture
    per_step = []
    for batch in batches[1:]:
        before = ba.bag_adagrad.launches
        losses.append(step(params, opt_state, batch))
        per_step.append(ba.bag_adagrad.launches - before)
    torch.cuda.synchronize()
    check(per_step == [ba.LAUNCHES] * len(per_step),
          f"bag_adagrad launches a train step {per_step}, not {ba.LAUNCHES}")
    check(all(bool(torch.isfinite(l)) for l in losses), "a non-finite loss")
    i = [0]

    def one():
        i[0] = (i[0] + 1) % len(batches)
        step(params, opt_state, batches[i[0]])
    step_ms = cuda_ms(one, 10, warmup=2)
    _, busy_ms, top = profile_top(one, calls=5)
    print(f"  DLRM-DCNv2 train step at B={b} through make_train_step: {per_step[0]} bag_adagrad "
          f"launches a replay ({len(per_step)} replays), {step_ms:.3f} ms a step between "
          f"events, {1e3 * b / step_ms:,.0f} examples/s, {busy_ms:.3f} ms busy {where}")
    for key, ms, n_calls in top:
        print(f"    {ms:8.4f} ms  x{n_calls:g}  {key}")
    del params, opt_state, step, batches
    torch.cuda.empty_cache()
    return {"kernel_ms": round(kernel_ms, 4), "bound_ms": round(bound_ms, 4),
            "plain_ms": round(torch_ms, 4), "distinct_rows": distinct,
            "grad_gap": grad_gap, "change_gap": change_gap,
            "launches_per_train_step": per_step[0], "train_step_ms": round(step_ms, 3)}


def serving_phases(args, cfg, card: str, params_cpu, reqs) -> dict:
    """Phases 4 to 7: fp32 and int8 serving through the Predictor, the tower's
    two kernels against the plain version, times. Returns the kernels line's
    entries of the int8 tower on the main path."""
    from xsdeepfwfm_deprecated_torch.compression.quantization import (
        convert, quantized_forward, quantized_lookup_serving)
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import (
        int8_mlp, int8_mlp_reference, prof_steps, tower_route, untile_weight)
    from xsdeepfwfm_deprecated_torch.ops.embedding import packed_lookup_serving
    from xsdeepfwfm_deprecated_torch.serving.predictor import Predictor

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

    return {"launches": launches, "max_abs_err": max_err, "max_abs_diff": max_err,
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms,
            "layered_ms": layered_ms, "layered_max_abs_err": layered_err,
            "kernels_per_call": kernels_per_call["cluster"],
            "layered_kernels_per_call": kernels_per_call["layered"],
            "one_wave_ms": one_wave, "one_wave_layered_ms": one_wave_layered,
            "event_ms": k_ev, "layered_event_ms": layered_ev}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=100, help="timed calls per kernel")
    ap.add_argument("--profile-sharded", action="store_true",
                    help="profile a step of each exchange in phase 17 (the profiler's start on "
                         "every rank adds tens of seconds to the phase)")
    ap.add_argument("--phases", type=int, nargs="+", choices=range(4, LAST_PHASE + 1),
                    metavar="N", help="phases 1 to 3, then the groups of the listed phases "
                    "(4-7, 8-11, 12-16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27), without the "
                    "result lines")
    ap.add_argument("--parity", nargs=2, metavar=("CHECKPOINT", "CACHE"),
                    help="phases 1 to 3, then tools.int8_auc_parity on a saved checkpoint with "
                         "the fused tower's launches and its max |diff| against the plain "
                         "version, without the result lines")
    args = ap.parse_args(argv)

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xsdeepfwfm_deprecated_torch.entry import flagship_config
    from xsdeepfwfm_deprecated_torch.models import deepfwfm
    from xsdeepfwfm_deprecated_torch.ops.cuda import _build
    from xsdeepfwfm_deprecated_torch.ops.cuda.int8_mlp import max_active_clusters
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

    if args.phases:
        groups = {first for first, last in PHASE_GROUPS
                  for n in args.phases if first <= n <= last}
        if 4 in groups:
            serving_phases(args, cfg, card, params_cpu, reqs)
        for first, run in ((8, training_phases), (12, deploy_phases), (17, sharded_phase)):
            if first in groups:
                run(args, cfg, card)
        for first, run in ((18, scale_phase), (19, pipeline_phase)):
            if first in groups:
                run(card)
        for first, run in ((20, dispatch_phase), (21, timers_phase), (22, per_batch_phase),
                           (23, last_forms_phase)):
            if first in groups:
                run(args, cfg, card)
        if 24 in groups:
            optimizer_phase(args, card)
        if 25 in groups:
            refresh_phase(args, card)
        if 26 in groups:
            cin_phase(args, card)
        if 27 in groups:
            bag_update_phase(args, card)
        print(card)
        return 0
    if args.parity:
        parity_run(*args.parity, card)
        print(card)
        return 0

    # each phase group's fused Adam and prune_search launches, a rank's included: the
    # kernels line's. A path that trains must launch fused Adam, one that refreshes the
    # pruning prune_search, and every other path neither.
    from xsdeepfwfm_deprecated_torch.ops.cuda.bag_adagrad import bag_adagrad
    from xsdeepfwfm_deprecated_torch.ops.cuda.cin import cin
    from xsdeepfwfm_deprecated_torch.ops.cuda.fused_adam import fused_adam
    from xsdeepfwfm_deprecated_torch.ops.cuda.prune_search import prune_search
    adam, prune, cins, bags = {}, {}, {}, {}

    def counting_adam(path: str, trains: bool, prunes: bool, run, *run_args,
                      xdeepfm: bool = False, dlrm: bool = False) -> dict:
        fused_adam.launches = prune_search.launches = cin.launches = bag_adagrad.launches = 0
        out = run(*run_args) or {}
        check(cin.launches > 0 if xdeepfm else cin.launches == 0,
              f"the {path} path made {cin.launches} CIN launches")
        cins[f"launches_{path}_path"] = cin.launches
        check(bag_adagrad.launches > 0 if dlrm else bag_adagrad.launches == 0,
              f"the {path} path made {bag_adagrad.launches} bag_adagrad launches")
        bags[f"launches_{path}_path"] = bag_adagrad.launches
        n = fused_adam.launches + out.pop("rank_adam_launches", 0)
        check(n > 0 if trains else n == 0, f"the {path} path made {n} fused Adam launches")
        adam[f"launches_{path}_path"] = n
        n = prune_search.launches + out.pop("rank_prune_launches", 0)
        check(n > 0 if prunes else n == 0, f"the {path} path made {n} prune_search launches")
        prune[f"launches_{path}_path"] = n
        return out

    # ---- 4-7. serving
    served = counting_adam("serving", False, False, serving_phases, args, cfg, card, params_cpu, reqs)

    # ---- 8-11. the training path
    trained = counting_adam("training", True, True, training_phases, args, cfg, card)

    # ---- 12-16. the deploy path through the CLIs
    deployed = counting_adam("cli", True, True, deploy_phases, args, cfg, card)

    # ---- 17. sharded training
    sharded = counting_adam("sharded", True, True, sharded_phase, args, cfg, card)

    # ---- 18. quality at scale
    scaled = counting_adam("scale", True, True, scale_phase, card)

    # ---- 19. the bin input pipeline
    piped = counting_adam("pipeline", True, False, pipeline_phase, card)

    # ---- 20. the compiled dispatch, graphed against eager
    dispatched = counting_adam("dispatch", True, True, dispatch_phase, args, cfg, card)

    # ---- 21. the compiled timers, beside the eager readings
    timed_path = counting_adam("timers", False, True, timers_phase, args, cfg, card)

    # ---- 22. the per-batch compiled dispatch: fit at steps_per_call=1, graphed against eager
    per_batch = counting_adam("per_batch", True, True, per_batch_phase, args, cfg, card)

    # ---- 23. the last compiled forms: the hash-MLP baseline's fit, graphed against eager
    counting_adam("hash_mlp", True, False, last_forms_phase, args, cfg, card)

    # ---- 24. the fused Adam kernel alone, beside its bound
    optimized = optimizer_phase(args, card)

    # ---- 25. the prune refresh alone, beside its bound
    refreshed = refresh_phase(args, card)

    # ---- 26. the CIN's layer kernels and the xDeepFM cell's train step
    cin_out = counting_adam("xdeepfm", True, False, cin_phase, args, card, xdeepfm=True)

    # ---- 27. DLRM-DCNv2's sparse Adagrad kernel and the DLRM cell's train step (Adagrad:
    # no fused Adam)
    bag_out = counting_adam("dlrm", False, False, bag_update_phase, args, card, dlrm=True)
    for name, counts in (("fused Adam", adam), ("prune_search", prune), ("cin", cins),
                         ("bag_adagrad", bags)):
        print(f"  {name} launches by path (graph replays counted): "
              + ", ".join(f"{k[len('launches_'):-len('_path')]} {v}" for k, v in counts.items()))

    # ---- result lines
    kernels = [{
        "name": "int8_mlp", "route": "cuda",
        "source": "xsdeepfwfm_deprecated_torch/csrc/int8_mlp.cu",
        "replaces": "xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26",
        **served, **trained, **deployed, **sharded, **scaled, **piped, **dispatched,
        **timed_path, **per_batch},
        {"name": "fused_adam", "route": "cuda",
         "source": "xsdeepfwfm_deprecated_torch/csrc/fused_adam.cu", "replaces": None,
         **adam, **optimized},
        {"name": "prune_search", "route": "cuda",
         "source": "xsdeepfwfm_deprecated_torch/csrc/prune_search.cu", "replaces": None,
         **prune, **refreshed},
        {"name": "cin", "route": "cuda", "source": "xsdeepfwfm_deprecated_torch/csrc/cin.cu",
         "replaces": None, **cins, **cin_out},
        {"name": "bag_adagrad", "route": "cuda",
         "source": "xsdeepfwfm_deprecated_torch/csrc/bag_adagrad.cu", "replaces": None,
         **bags, **bag_out}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
