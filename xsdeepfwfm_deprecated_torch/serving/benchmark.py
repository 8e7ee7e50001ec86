"""Serving / benchmark harness: quality + profiler trace + latency sweep.

Port of ``xsdeepfwfm_deprecated_tpu/serving/benchmark.py:30-253``, the parity
surface of the reference's ``run_benchmark`` (``model/DeepFMs.py:947-1009``):

1. quality metrics over the test set (logloss/AUC/PRAUC/RCE);
2. a profiler pass with a chrome-trace export, an op-level summary table and
   device-memory accounting, the counterpart of the reference's
   ``prof.key_averages()`` printout with ``profile_memory=True``
   (``model/DeepFMs.py:975-978``);
3. batched forward timing (default batch 8192) → ms/batch and examples/s;
4. single-example latency (batch=1) over 1000 samples → mean ms.

The result dict has the JAX package's keys and the log lines its text.
``batch_ms`` and ``single_example_ms`` are the host clock with a device sync
per call; ``batch_onchip_ms`` and ``single_example_onchip_ms`` are CUDA-event
times (:mod:`..utils.profiling`). In place of XLA's cost analysis,
``flops_per_batch`` comes from ``torch.utils.flop_counter`` (matrix products
of the eager forward; a hand-written kernel's are not counted) and
``bytes_accessed_per_batch`` is left out. The lookup row times the flat
serving lookup, the port's one layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import deepfwfm
from ..ops import interactions as inter_ops
from ..ops import mlp as mlp_ops
from ..ops.embedding import packed_lookup_serving
from ..train import metrics as M
from ..utils.profiling import marginal_timeit, scan_timeit, simple_timeit, trace
from .predictor import Predictor


def memory_summary(device: Optional[torch.device] = None) -> Dict[str, float]:
    """Device memory accounting under the JAX package's key names, from the
    caching allocator's statistics and ``mem_get_info``. ``device=None`` is
    the current CUDA device. Returns ``{}`` on the CPU, which has no
    allocator statistics. (``largest_alloc_size`` has no counterpart in
    PyTorch's statistics and is left out, as a missing key is there.)"""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda")
    if torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(total)}


def _rolled(arr: torch.Tensor, k: int = 8) -> List[torch.Tensor]:
    return [torch.roll(arr, i, dims=0) for i in range(k)]


@torch.inference_mode()
def op_summary(predictor: Predictor, bxi: np.ndarray, bxv: np.ndarray,
               log=print) -> Dict[str, float]:
    """Op-level summary of the serving forward.

    Counterpart of ``prof.key_averages().table(sort_by='self_cpu_time_total')``
    (reference ``model/DeepFMs.py:975-978``), from two sources:

    * the matrix-product FLOPs of one forward (``FlopCounterMode``);
    * the device time of the forward's named components (the reference's
      ``record_function`` spans: lookup / interaction / deep tower), each run
      alone over distinct inputs and timed with CUDA events.
    """
    from torch.utils.flop_counter import FlopCounterMode

    results: Dict[str, float] = {}
    dev = predictor.device
    xi_d = torch.from_numpy(np.asarray(bxi, np.int32)).to(dev)
    xv_d = torch.from_numpy(np.asarray(bxv, np.float32)).to(dev)
    model = predictor._model

    with FlopCounterMode(display=False) as counter:
        predictor._fn(model, xi_d, xv_d)
    if counter.get_total_flops():
        results["flops_per_batch"] = float(counter.get_total_flops())

    def _marg(fn, variants):
        return marginal_timeit(fn, model, variants, k2=len(variants), reps=5)

    rows: List[Tuple[str, float]] = []
    if isinstance(model, dict):   # fp32 params: component sub-functions exist
        cfg = predictor.cfg
        spec = deepfwfm.make_embedding_spec(cfg)
        b = xi_d.shape[0]
        zero_rates = (0.0,) * (cfg.h_depth + 1)

        if "emb2" in model:
            f_lookup = lambda p, xi, xv: packed_lookup_serving(p["emb2"], spec, xi, xv)
            rows.append(("Embedding lookup (packed gather)",
                         _marg(f_lookup, [(x, xv_d) for x in _rolled(xi_d)])))
            emb2_d = f_lookup(model, xi_d, xv_d)
            if cfg.use_fwfm and "field_cov" in model:
                rows.append(("FwFM interaction (R-weighted pairs)",
                             _marg(lambda p, e: inter_ops.fwfm_second_order(e, p["field_cov"]),
                                   [(e,) for e in _rolled(emb2_d)])))
            elif cfg.use_fm:
                rows.append(("FM interaction (sum-of-squares)",
                             _marg(lambda p, e: inter_ops.fm_second_order(e),
                                   [(e,) for e in _rolled(emb2_d)])))
            if cfg.use_deep and "deep" in model:
                deep_in_d = emb2_d.reshape(b, -1)
                rows.append(("Deep tower (MLP)",
                             _marg(lambda p, x: mlp_ops.mlp_forward(
                                 p["deep"]["net_1"], x, dropout_rates=zero_rates, train=False),
                                 [(x,) for x in _rolled(deep_in_d)])))

    rows.append(("Full forward", _marg(predictor._fn, [(x, xv_d) for x in _rolled(xi_d)])))

    # --- render, reference-table style (sorted by self time desc) ----------
    log("\tOp-level summary (batch {}):".format(bxi.shape[0]))
    log("\t  {:<38s} {:>12s} {:>10s}".format("component", "time (ms)", "share"))
    total = rows[-1][1]
    for name, t in sorted(rows, key=lambda r: -r[1]):
        log("\t  {:<38s} {:>12.3f} {:>9.1f}%".format(
            name, t * 1e3, 100.0 * t / max(total, 1e-12)))
        results[f"component_ms/{name}"] = t * 1e3
    if "flops_per_batch" in results:
        log("\t  Flop counter: {:.3f} GFLOP/batch in matrix products".format(
            results["flops_per_batch"] / 1e9))

    mem = memory_summary(dev)
    if mem:
        log("\t  Device memory: {:.1f} MB in use, {:.1f} MB peak{}".format(
            mem.get("bytes_in_use", 0.0) / 1e6,
            mem.get("peak_bytes_in_use", 0.0) / 1e6,
            ", {:.0f} MB limit".format(mem["bytes_limit"] / 1e6)
            if "bytes_limit" in mem else ""))
        results.update({f"memory/{k}": v for k, v in mem.items()})
    else:
        log("\t  Device memory: no allocator stats on this backend")
    return results


@torch.inference_mode()
def run_benchmark(predictor: Predictor, Xi, Xv, y, *, batch_size: int = 8192,
                  trace_dir: Optional[str] = None, logger=None,
                  n_single: int = 1000) -> Dict[str, float]:
    """Full benchmark; returns a dict of every measured number."""
    log = (logger.info if logger is not None else print)
    Xi = np.asarray(Xi, np.int32).reshape(-1, predictor.cfg.num_categorical)
    Xv = np.asarray(Xv, np.float32)
    y = np.asarray(y, np.float64).ravel()
    n = Xi.shape[0]
    dev = predictor.device
    results: Dict[str, float] = {}

    # 1. quality (reference :953-957)
    logits = []
    for lo in range(0, n, batch_size):
        sl = slice(lo, min(n, lo + batch_size))
        logits.append(predictor.logits(Xi[sl], Xv[sl]))
    logits = np.concatenate(logits).astype(np.float64)
    pred = 1.0 / (1.0 + np.exp(-logits))
    results["loss"] = M.bce_logits_sum(y, logits) / max(n, 1)
    results["auc"] = M.roc_auc(y, pred)
    results["prauc"] = M.prauc(pred, y)
    results["rce"] = M.rce(pred, y)
    log(f"\tLoss: {results['loss']}")
    log(f"\tAcc: {results['auc']}")
    log(f"\tPRAUC: {results['prauc']}")
    log(f"\tRCE: {results['rce']}")

    # 2. profiler pass with trace export (reference :975-978)
    bxi, bxv = Xi[:batch_size], Xv[:batch_size]
    if bxi.shape[0] < batch_size:   # pad for a full batch
        reps = -(-batch_size // max(bxi.shape[0], 1))
        bxi = np.tile(bxi, (reps, 1))[:batch_size]
        bxv = np.tile(bxv, (reps, 1))[:batch_size]
    predictor.warmup(batch_sizes=(1, batch_size))
    with trace(trace_dir):
        predictor.logits(bxi, bxv)
    results.update(op_summary(predictor, bxi, bxv, log=log))

    # 3. batched forward timing (reference :982-997). Two numbers: the host
    # clock with a sync per call (what a caller of the forward sees) and the
    # device's time over k2 distinct batches. The tensors are moved to the
    # device once, outside the timed calls: the reference's time_forward_pass
    # also times only the forward, after tensor construction (:1012-1028).
    k2 = 8
    binputs = []
    for i in range(k2):
        sl = np.arange(i, i + batch_size) % n
        binputs.append((torch.from_numpy(Xi[sl] if n >= batch_size else bxi).to(dev),
                        torch.from_numpy(Xv[sl] if n >= batch_size else bxv).to(dev)))
    bxi_d, bxv_d = binputs[0]
    t_batch = simple_timeit(lambda: predictor._fn(predictor._model, bxi_d, bxv_d), tries=20)
    t_chip = marginal_timeit(predictor._fn, predictor._model, binputs, k2=k2, reps=5)
    results["batch_ms"] = t_batch * 1e3
    results["batch_onchip_ms"] = t_chip * 1e3
    results["examples_per_s"] = batch_size / t_chip
    # a Predictor occupies one device
    results["examples_per_s_per_chip"] = results["examples_per_s"]
    log("\tAvg forward pass time per batch (ms):\t{:.3f} wall / {:.3f} on-chip".format(
        results["batch_ms"], results["batch_onchip_ms"]))
    log("\tThroughput (examples/s, on-chip):\t{:.0f}".format(results["examples_per_s"]))
    log("\tThroughput (examples/s/chip):\t{:.0f}".format(results["examples_per_s_per_chip"]))

    # 4. single-example latency (reference :999-1009): host clock and device
    # time of back-to-back forwards of one example
    xi1 = torch.from_numpy(Xi[:1]).to(dev)
    xv1 = torch.from_numpy(Xv[:1]).to(dev)
    t_single = simple_timeit(lambda: predictor._fn(predictor._model, xi1, xv1),
                             tries=min(n_single, 1000), warmup=3)
    t1_chip = scan_timeit(predictor._fn, predictor._model, xi1, xv1,
                          iters=min(n_single, 1000), reps=3)
    results["single_example_ms"] = t_single * 1e3
    results["single_example_onchip_ms"] = t1_chip * 1e3
    log("\tAvg forward pass time (ms):\t{:.3f} wall / {:.3f} on-chip".format(
        results["single_example_ms"], results["single_example_onchip_ms"]))
    return results
