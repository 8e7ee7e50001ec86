"""Pruned-serving benchmark: the dense flagship against its pruned, compacted
and int8 variants.

Port of ``scripts/pruned_serving_bench.py``, with its flags and output (the
compaction reports and per-arm times on stderr, one JSON line per arm and
batch size on stdout). The reference's sparse-serving study measured
single-example CSR speedups on a CPU; on a dense accelerator the win comes
from structural compaction (:mod:`..serving.compaction`), not CSR:

* ``unstructured-compact``: the paper's D-90/R-90/F-40 recipe applied element
  by element, then compacted: scattered zeros leave no dead units, so the
  tower cannot shrink; only all-zero table rows go;
* ``structured-compact``: D-90 by whole units (``structured_deep``), so the
  400^3 tower compacts to a smaller dense one, and ``structured-tower-only``
  without the row remap;
* ``int8``: weight-only int8 tables and the dynamic-int8 tower (the fused
  kernel on the card at B=8192); ``int8-structured-compact`` and
  ``int8-structured-tower-only`` on top of structured compaction.

Every arm is served by the :class:`Predictor`. Times are device times of
the arm's forward captured into CUDA graphs, as the script's are of its jitted
forward: ``marginal_timeit`` over 16 distinct seeded batches at B=8192,
``scan_timeit`` of 200 back-to-back calls at B=1 (single-request latency is
serial).

``--checkpoint`` loads trained pruned params (``synthetic_scale_run --save``'s
``<save>_deeplight``) instead of pruning the random init; ``--zero-rows``
also zeroes that fraction of emb2's rows. ``--smoke``: a small model on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..compression.pruning import prune_params
from ..compression.quantization import convert
from ..device import DeviceLike, resolve_device
from ..entry import flagship_config
from ..models import deepfwfm
from ..serving.compaction import compact_for_serving, compaction_report
from ..serving.predictor import Predictor
from ..utils.profiling import marginal_timeit, scan_timeit
from ..weights import load_jax_checkpoint


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default="", help="pruned checkpoint to load")
    ap.add_argument("--zero-rows", type=float, default=0.0,
                    help="force this all-zero-row fraction into emb2")
    ap.add_argument("--sparse", type=float, default=0.9)
    ap.add_argument("--emb-r", type=float, default=0.444)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batches", default="8192,1")
    ap.add_argument("--smoke", action="store_true",
                    help="small model on the CPU (smoke tests)")
    return ap


def main(argv=None, device: DeviceLike = None) -> list:
    """Returns the printed rows."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.smoke else device)

    cfg = (flagship_config(full_criteo=False, feature_scale=64, deep_nodes=64,
                           embedding_size=8)
           if args.smoke else flagship_config(full_criteo=True))
    if args.checkpoint:
        params = load_jax_checkpoint(args.checkpoint, cfg, device=device)
        print(f"loaded {args.checkpoint}", file=sys.stderr)
    else:
        params = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device=device)

    rng = np.random.default_rng(0)

    def prune(p, structured):
        # the paper recipe's rates: D at `sparse`, R at sparse*1.0, F at sparse*emb_r
        p = prune_params(p, args.sparse, emb_r=args.emb_r,
                         emb_corr=1.0, prune_fm=not args.checkpoint,
                         prune_deep=True, prune_r=True,
                         structured_deep=structured)
        if args.zero_rows > 0:
            t = p["emb2"]["dense"].cpu().numpy().copy()
            kill = rng.random(t.shape[0]) < args.zero_rows
            t[kill] = 0.0
            p = dict(p)
            p["emb2"] = dict(p["emb2"])
            p["emb2"]["dense"] = torch.from_numpy(t).to(device)
        return p

    p_unstr = prune(params, structured=False)
    p_struct = prune(params, structured=True)

    cm_unstr = compact_for_serving(p_unstr, cfg)
    cm_struct = compact_for_serving(p_struct, cfg)
    cm_tower = compact_for_serving(p_struct, cfg, compact_rows=False)
    cm_struct8 = compact_for_serving(p_struct, cfg, int8=True)
    cm_tower8 = compact_for_serving(p_struct, cfg, int8=True, compact_rows=False)
    qm = convert(params, cfg, mode="dynamic")

    print("compaction (unstructured):",
          json.dumps({k: v for k, v in compaction_report(p_unstr, cm_unstr, cfg).items()
                      if not k.startswith("tower_shapes")}), file=sys.stderr)
    rep_s = compaction_report(p_struct, cm_struct, cfg)
    print("compaction (structured):  ",
          json.dumps({k: v for k, v in rep_s.items()
                      if not k.startswith("tower_shapes")}), file=sys.stderr)
    print("  structured tower:", rep_s["tower_shapes_orig"], "→",
          rep_s["tower_shapes_compact"], file=sys.stderr)

    arms = [
        ("fp32-dense", Predictor(params, cfg, device=device)),
        ("unstructured-compact", Predictor(cm_unstr, device=device)),
        ("structured-compact", Predictor(cm_struct, device=device)),
        ("structured-tower-only", Predictor(cm_tower, device=device)),
        ("int8", Predictor(qm, device=device)),
        ("int8-structured-compact", Predictor(cm_struct8, device=device)),
        ("int8-structured-tower-only", Predictor(cm_tower8, device=device)),
    ]

    rows = []
    K2 = 4 if args.smoke else 16
    with torch.inference_mode():
        for bstr in args.batches.split(","):
            b = int(bstr)
            b = min(b, 256) if args.smoke else b
            inputs = []
            for _ in range(K2):
                xi = rng.integers(0, [s for s in cfg.feature_sizes[13:]],
                                  size=(b, 26)).astype(np.int32)
                xv = rng.normal(size=(b, 13)).astype(np.float32)
                inputs.append((torch.from_numpy(xi).to(device), torch.from_numpy(xv).to(device)))
            for name, pred in arms:
                if b == 1:
                    # single-request latency is serial: back-to-back calls of one input
                    t = scan_timeit(pred._fn, pred._model, *inputs[0],
                                    iters=200, reps=3)
                else:
                    t = marginal_timeit(pred._fn, pred._model, inputs, k2=K2,
                                        reps=3 if args.smoke else 7)
                rows.append({"arm": name, "batch": b, "us_per_batch": t * 1e6,
                             "examples_per_s": b / t})
                print(f"  b={b:5d} {name:24s} {t * 1e6:10.1f} µs/batch "
                      f"{b / t:14,.0f} ex/s", file=sys.stderr)

    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
