"""QR embeddings at paper scale: the dense flagship against ``-qr_emb 1
-qr_collisions 4`` on the synthetic cache.

Port of ``scripts/qr_scale_run.py``, with its flags and JSON lines. The
reference measured quotient-remainder compositional embeddings at about 3x
fewer embedding parameters for -0.0028 AUC on full Criteo. For each arm, on
the 1M-row full-Criteo-dims cache of :mod:`.synthetic_scale_run`:

* the valid-AUC trajectory and the best test AUC;
* the embedding tables' bytes (the 3x-parameters claim);
* ms per train step at B=2048: one 16-step ``make_multi_step`` dispatch
  over 16 distinct seeded batches (a CUDA graph replay on the card) between
  CUDA events, the median of 5, over 16, as the script times its 16-step
  ``lax.scan``. The script's scan runs over super-row-packed parameters, a
  TPU layout the port does not have; the port's steps update the same
  parameters in the flat table;
* serving throughput at B=8192 (``kd_scale_run.serving_ms``'s protocol).

``--cpu`` runs on the CPU (``main(argv, device="cpu")``).

Usage: python -m xsdeepfwfm_deprecated_torch.tools.qr_scale_run --cache synth1m.npz
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from .. import _tree
from ..config import ModelConfig, TrainConfig
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..train.trainer import DeepFMEstimator, make_multi_step, make_optimizer
from ..utils.profiling import timed
from .kd_scale_run import best_params_on, serving_ms


def table_bytes(params) -> int:
    tot = 0
    for group in ("emb1", "emb2"):
        if group in params:
            tot += sum(t.numel() * t.element_size() for t in _tree.leaves(params[group]))
    return tot


def train_step_ms(mcfg, k=16, b=2048, device: DeviceLike = None) -> float:
    """Median ms per train step of one ``k``-step dispatch, as the script
    times it: ``make_multi_step`` over ``k`` distinct seeded batches of ``b``
    rows (one CUDA graph replay on the card, the steps run eagerly on the
    CPU), one warm-up dispatch (on the card the capture), then 5 dispatches
    between two CUDA events (the host clock on the CPU), each from the state
    the previous one left; the median over ``k``."""
    device = resolve_device(device)
    tcfg = TrainConfig(batch_size=b, steps_per_call=k)
    params = deepfwfm.init_params(torch.Generator().manual_seed(0), mcfg, device=device)
    optimizer = make_optimizer(tcfg)
    opt_state = optimizer.init(params)
    multi = make_multi_step(mcfg, tcfg, optimizer)
    rng = np.random.default_rng(0)
    xi = rng.integers(0, [s for s in mcfg.feature_sizes[13:]],
                      size=(k, b, 26)).astype(np.int32)
    xv = rng.normal(size=(k, b, 13)).astype(np.float32)
    y = (rng.random((k, b)) < 0.3).astype(np.float32)
    xi, xv, y = (torch.from_numpy(a).to(device) for a in (xi, xv, y))
    mask = torch.ones((k, b), device=device)
    gen = torch.Generator(device=device).manual_seed(1)

    def run() -> None:
        multi(params, opt_state, xi, xv, y, mask, gen, k_real=k)

    cuda = device.type == "cuda"
    timed(run, cuda)
    return statistics.median(timed(run, cuda) for _ in range(5)) / k * 1e3


def serving_m_ex_s(est, Xi, Xv, b=8192):
    """(M examples/s, ms) a ``b``-row batch, by ``kd_scale_run.serving_ms``."""
    ms = serving_ms(est, Xi, Xv, b)
    return b / ms / 1e3, ms


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "synth1m.npz"))
    ap.add_argument("--collisions", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (smoke tests)")
    return ap


def main(argv=None, device: DeviceLike = None) -> list:
    """Returns the RESULT dict of each arm."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)

    z = np.load(args.cache)
    xi, xv, y = z["xi"], z["xv"], z["y"]
    sizes = tuple(int(s) for s in z["feature_sizes"])
    n = len(y)
    n_test = n // 10
    te, va, tr = slice(0, n_test), slice(n_test, 2 * n_test), slice(2 * n_test, n)

    results = []
    for qr in (False, True):
        mcfg = ModelConfig(
            field_size=39, feature_sizes=sizes, numerical=13,
            embedding_size=10, h_depth=3, deep_nodes=400,
            use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True,
            qr_flag=qr, qr_collisions=args.collisions, qr_threshold=200,
            qr_operation="mult")
        tcfg = TrainConfig(n_epochs=args.epochs, batch_size=args.batch,
                           learning_rate=1e-3, weight_decay=3e-7,
                           random_seed=0, steps_per_call=10,
                           eval_train_rows=200000)
        est = DeepFMEstimator(mcfg, tcfg, device=device)
        t0 = time.time()
        est.fit(xi[tr], xv[tr], y[tr], xi[va], xv[va], y[va], keep_best=True)
        wall = time.time() - t0
        loss, auc, _, _ = est.eval_by_batch(xi[te], xv[te], y[te])
        out = {"arm": "qr%d" % args.collisions if qr else "dense",
               "valid_auc_by_epoch": [round(v, 4) for v in est.valid_result],
               "test_auc": round(auc, 4), "test_logloss": round(loss, 4),
               "train_wall_s": round(wall, 1),
               "emb_table_mb": round(table_bytes(est.params) / 1e6, 1)}
        if est.best_params is not None:
            final = est.params
            est.params = best_params_on(est)
            _, ba, _, _ = est.eval_by_batch(xi[te], xv[te], y[te])
            out["best_test_auc"] = round(ba, 4)
            est.params = final
        out["train_step_ms_b2048"] = round(train_step_ms(mcfg, device=device), 3)
        mexs, ms = serving_m_ex_s(est, xi[te], xv[te])
        out["serve_b8192_m_ex_s"] = round(mexs, 2)
        out["serve_b8192_ms"] = round(ms, 3)
        print("RESULT " + json.dumps(out), flush=True)
        results.append(out)
    return results


if __name__ == "__main__":
    main()
