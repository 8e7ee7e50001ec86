"""Fused-int8 quality at scale: test AUC of one checkpoint served three ways.

Port of ``scripts/int8_auc_parity.py``, with its flags and JSON line. The
reference finds an identical AUC after dynamic int8 quantization; this
measures test AUC and logloss on the synthetic test slice
(:mod:`.synthetic_scale_run`'s cache) for three serving paths off one
checkpoint, written by either package:

* fp32 (the checkpointed model as it is);
* int8 layerwise (dynamic scales, one ``quantized_dense`` a layer);
* int8 fused (the whole tower in one kernel per call, ``int8_mlp``'s cluster
  kernel on the card, per-512-row-tile scales).

The test slice is padded with copies of its first row to a multiple of
``--batch``, which must be a multiple of 512 for the fused path.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.int8_auc_parity \\
      --checkpoint saved_models/synth10m_dense --cache synth10m.npz
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from ..compression.quantization import FUSED_BLOCK_B, convert, quantized_forward
from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..train import metrics as M
from ..weights import load_jax_checkpoint


def model_config(feature_sizes, n_num: int) -> ModelConfig:
    """The flagship's architecture (E=10, 400^3, lw+fwlw) on the cache's fields."""
    return ModelConfig(field_size=len(feature_sizes),
                       feature_sizes=tuple(feature_sizes), numerical=n_num,
                       embedding_size=10, h_depth=3, deep_nodes=400,
                       use_fwfm=True, use_deep=True, use_lw=True, use_fwlw=True)


@torch.inference_mode()
def batched_logits(fn: Callable, model, xi_p: np.ndarray, xv_p: np.ndarray, b: int,
                   device: torch.device) -> np.ndarray:
    """Every ``b``-row batch through ``fn`` on ``device``, one copy back."""
    out = []
    for lo in range(0, len(xi_p), b):
        out.append(fn(model, torch.from_numpy(xi_p[lo:lo + b]).to(device),
                      torch.from_numpy(xv_p[lo:lo + b]).to(device)))
    return torch.cat(out).cpu().numpy()


def n_test_rows(n_rows: int, requested: int = 0) -> int:
    """Rows of the test slice of an ``n_rows`` cache: ``requested``, else a
    tenth of the rows (at least 1,000), as the ``synthetic_scale_run`` splits."""
    return requested or max(n_rows // 10, 1000)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--cache", required=True, help="synthetic dataset npz")
    ap.add_argument("--batch", type=int, default=8192,
                    help="eval batch (must be %%512==0 for the fused path)")
    ap.add_argument("--test-rows", type=int, default=0,
                    help="test-slice rows (default: rows//10 as in the "
                         "synthetic_scale_run splits)")
    return ap


def main(argv=None, device: DeviceLike = None) -> Dict:
    """Returns the printed results dict."""
    args = get_parser().parse_args(argv)
    device = resolve_device(device)

    z = np.load(args.cache)
    xi, xv, y = z["xi"], z["xv"], z["y"]
    feature_sizes = z["feature_sizes"].tolist()
    n_test = n_test_rows(len(y), args.test_rows)
    xi, xv, y = xi[:n_test], xv[:n_test], y[:n_test].astype(np.float64)

    cfg = model_config(feature_sizes, xv.shape[1])
    params = load_jax_checkpoint(args.checkpoint, cfg, device=device)
    qm = convert(params, cfg, mode="dynamic")

    fns = {
        "fp32": lambda m, a, v: deepfwfm.forward(m, a, v, cfg),
        "int8-layerwise": lambda m, a, v: quantized_forward(m, a, v, use_fused_kernel=False),
        "int8-fused": lambda m, a, v: quantized_forward(m, a, v, use_fused_kernel=True),
    }
    b = args.batch
    assert b % FUSED_BLOCK_B == 0, "fused path needs batch % 512 == 0"
    pad = (-len(y)) % b
    xi_p = np.concatenate([xi, np.repeat(xi[:1], pad, 0)]) if pad else xi
    xv_p = np.concatenate([xv, np.repeat(xv[:1], pad, 0)]) if pad else xv

    results: Dict = {}
    fp32_logits = None
    for name, fn in fns.items():
        model = params if name == "fp32" else qm
        logits = batched_logits(fn, model, xi_p, xv_p, b, device)[:n_test].astype(np.float64)
        pred = 1.0 / (1.0 + np.exp(-logits))
        results[name] = {
            "auc": round(M.roc_auc(y, pred), 5),
            "logloss": round(M.bce_logits_sum(y, logits) / n_test, 5),
        }
        if name == "fp32":
            fp32_logits = logits
        else:
            results[name]["logit_corr_vs_fp32"] = round(float(np.corrcoef(
                logits, fp32_logits)[0, 1]), 5)
    results["fused_vs_fp32_auc_gap"] = round(
        results["fp32"]["auc"] - results["int8-fused"]["auc"], 5)
    results["fused_vs_layerwise_auc_gap"] = round(
        results["int8-layerwise"]["auc"] - results["int8-fused"]["auc"], 5)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
