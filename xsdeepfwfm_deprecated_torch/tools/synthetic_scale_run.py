"""At-scale training and the DeepLight recipe on synthetic CTR data.

Port of ``scripts/synthetic_scale_run.py``, with its flags, defaults and JSON
lines. A known generative model is planted over Criteo-shaped data:
per-feature weights, low-rank pairwise field interactions (the structure FwFM
models) and a small planted MLP (the structure the deep tower models). The
AUC of the true logit is the oracle, the ceiling a trained model approaches.
:func:`make_synthetic` is the script's generator, so one seed gives the same
rows, bit for bit, in both packages, and a ``--cache`` npz written by either
is read by the other.

``--full-criteo-dims`` uses the real per-field cardinalities (1.33M features)
with zipf-skewed indices; ``--deeplight`` runs the paper's compression recipe
(warm-up and pruning epochs, a refresh every 10 iterations, D-90 / R-90 / F-40
via ``sparse=0.9, emb_corr=1.0, emb_r=0.444``); ``--compare`` trains the dense
baseline and the DeepLight run on the same data and reports the AUC gap;
``--qat`` trains with fake-quantized activations and serves the converted int8
model through the :class:`Predictor`, whose fused int8 tower runs on the card
at 8192 rows. ``--steps-per-call`` is ``fit``'s ``steps_per_call``: K steps a
dispatch, one CUDA graph replay on the card.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.synthetic_scale_run --rows 10000000 \\
      --full-criteo-dims --compare --eval-train-rows 500000
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import _tree
from ..compression.pruning import sparsity_report
from ..compression.quantization import convert
from ..config import ModelConfig, TrainConfig
from ..device import DeviceLike, resolve_device
from ..entry import FULL_CRITEO_CAT_SIZES as _CRITEO
from ..models import deepfwfm
from ..serving.predictor import Predictor
from ..train import checkpoint as ckpt
from ..train import metrics as M
from ..train.trainer import DeepFMEstimator

# full-Criteo per-field cardinalities (1.33M features)
FULL_CRITEO_CAT_SIZES = list(_CRITEO)

# Avazu-shaped: 23 fields, 1 numeric, ~1.54M features (the per-field split is
# synthesized: only Criteo's cardinalities are published)
AVAZU_CAT_SIZES = [
    241, 8, 8, 3697, 4614, 25, 5481, 329, 31, 700000, 800000, 6793, 6, 5,
    2509, 9, 10, 432, 5, 68, 169, 61]

SHAPES = {"criteo": (13, 26, FULL_CRITEO_CAT_SIZES),
          "avazu": (1, 22, AVAZU_CAT_SIZES)}

RANK, HID = 4, 32

SERVE_BATCH = 8192   # rows a Predictor call in the QAT leg


def _zipf_cdfs(cat_sizes, a=1.05):
    """Per-field zipf(a) CDF over ranks: inverse-transform sampling tables."""
    cdfs = []
    for s in cat_sizes:
        w = 1.0 / np.arange(1, s + 1, dtype=np.float64) ** a
        cdfs.append(np.cumsum(w / w.sum()))
    return cdfs


def make_synthetic(rows: int, seed: int = 0, full_dims: bool = False,
                   chunk: int = 250_000, min_count: int = 4,
                   shape: str = "criteo"):
    """Chunked generation of (xi, xv, y, feature_sizes, oracle_logit, kept).

    ``min_count``: ranks whose expected count over ``rows`` draws is below
    this are remapped to index 0 before the planted logit is computed, as the
    reference's preprocessing maps features seen fewer than 4 times to index
    0. Without it the zipf tail is millions of once-seen features whose labels
    the embedding table memorizes."""
    rng = np.random.default_rng(seed)
    n_num, n_cat, full_sizes = SHAPES[shape]
    cat_sizes = (list(full_sizes) if full_dims
                 else [int(c) for c in rng.integers(10, 50000, n_cat)])

    # planted model: linear + low-rank pairwise (FwFM structure) + small MLP
    w_num = (rng.normal(size=n_num) * 0.3).astype(np.float32)
    w_cat = [rng.normal(size=s).astype(np.float32) * 0.5 for s in cat_sizes]
    v_cat = [rng.normal(size=(s, RANK)).astype(np.float32) * 0.4
             for s in cat_sizes]
    field_strength = np.triu(rng.normal(size=(n_cat, n_cat)) * 0.15, 1
                             ).astype(np.float32)
    mlp_w1 = (rng.normal(size=(n_cat * RANK + n_num, HID)) *
              (1.0 / np.sqrt(n_cat * RANK + n_num))).astype(np.float32)
    mlp_w2 = (rng.normal(size=HID) * 0.8).astype(np.float32)

    cdfs = _zipf_cdfs(cat_sizes)
    # long-tail cutoff per field: largest rank with expected count >= min_count
    pmf0 = [np.diff(c, prepend=0.0) for c in cdfs]
    cutoffs = [int(np.searchsorted(-p * rows, -float(min_count)))
               for p in pmf0]
    kept = sum(cutoffs)
    xi = np.empty((rows, n_cat), np.int32)
    xv = rng.normal(size=(rows, n_num)).astype(np.float32)
    logit = np.empty(rows, np.float32)

    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        n = hi - lo
        for f in range(n_cat):
            u = rng.random(n)
            k = np.searchsorted(cdfs[f], u).astype(np.int32)
            xi[lo:hi, f] = np.where(k < cutoffs[f], k, 0)  # tail -> index 0
        part = xv[lo:hi] @ w_num
        emb = np.empty((n, n_cat, RANK), np.float32)
        for f in range(n_cat):
            idx = xi[lo:hi, f]
            part += w_cat[f][idx]
            emb[:, f] = v_cat[f][idx]
        gram = np.einsum("nfr,ngr->nfg", emb, emb)
        part += np.einsum("nfg,fg->n", gram, field_strength)
        feats = np.concatenate([emb.reshape(n, -1), xv[lo:hi]], axis=1)
        part += np.tanh(feats @ mlp_w1) @ mlp_w2      # planted nonlinearity
        logit[lo:hi] = part

    # normalize so the oracle AUC ceiling is high (~0.85+) and CTR ~ 0.25
    logit = (logit - logit.mean()) / (logit.std() + 1e-9) * 2.0 - 1.2
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    feature_sizes = [1] * n_num + cat_sizes
    return xi, xv, y, feature_sizes, logit, kept


def oracle_auc(logit, y):
    return M.roc_auc(np.asarray(y, np.float64), np.asarray(logit, np.float64))


def save_cache(path: str, xi, xv, y, logit, feature_sizes, kept) -> None:
    """The script's cache: the same npz keys and dtypes."""
    np.savez(path, xi=xi, xv=xv, y=y, logit=logit,
             feature_sizes=np.asarray(feature_sizes), kept=kept)


def load_cache(path: str):
    """(xi, xv, y, feature_sizes, logit, kept) from a cache of either package."""
    z = np.load(path)
    return (z["xi"], z["xv"], z["y"], z["feature_sizes"].tolist(), z["logit"],
            int(z["kept"]))


def train_one(xi, xv, y, feature_sizes, n_test, args, *, deeplight: bool,
              device: DeviceLike = None):
    """Fit one arm (dense, DeepLight, or QAT when ``args.qat`` and not
    DeepLight) and return the script's metrics dict."""
    device = resolve_device(device)
    n_num = SHAPES[args.shape][0]
    qat = bool(getattr(args, "qat", False)) and not deeplight
    mcfg = ModelConfig(field_size=len(feature_sizes),
                       feature_sizes=tuple(feature_sizes),
                       numerical=n_num, embedding_size=args.emb_size,
                       h_depth=3, deep_nodes=args.deep_nodes,
                       use_logit=args.lr_only, use_fm=False, use_ffm=False,
                       use_fwfm=not args.lr_only, use_deep=not args.lr_only,
                       use_lw=not args.lr_only, use_fwlw=not args.lr_only,
                       quantization_aware=qat,
                       table_dtype=getattr(args, "table_dtype", "f32"))
    # the paper's DeepLight recipes: warm + prune epochs, prune every 10
    # iterations; Criteo D-90/R-90/F-40 via sparse=0.9, emb_corr=1,
    # emb_r=0.444; Avazu D-98/R-90/F-0 via sparse=0.98, emb_corr=0.918, emb_r=0
    tcfg = TrainConfig(
        n_epochs=(args.epochs if not deeplight else args.warm + args.prune_epochs),
        batch_size=args.batch, learning_rate=1e-3, weight_decay=args.l2,
        random_seed=args.seed, steps_per_call=args.steps_per_call,
        prune=deeplight, prune_fm=True, prune_r=True, prune_deep=True,
        sparse=args.sparse, emb_r=args.emb_r, emb_corr=args.emb_corr,
        warm=args.warm, prune_omega=args.prune_omega,
        eval_train_rows=args.eval_train_rows)
    est = DeepFMEstimator(mcfg, tcfg, device=device)
    t0 = time.time()
    # the valid set is a held-out slice distinct from the test slice
    n_valid = n_test
    est.fit(xi[n_test + n_valid:], xv[n_test + n_valid:], y[n_test + n_valid:],
            xi[n_test:n_test + n_valid], xv[n_test:n_test + n_valid],
            y[n_test:n_test + n_valid], keep_best=True)
    wall = time.time() - t0
    if args.save:
        path = f"{args.save}_{'deeplight' if deeplight else 'dense'}"
        # the final params (for DeepLight the fully ramped sparsity pattern that
        # serving compaction takes), with the optimizer state for a resume
        est.save(path, epoch=tcfg.n_epochs - 1, sparse=deeplight)
        print(f"saved checkpoint: {path}")
        if est.best_params is not None:
            # the best-valid-epoch params too, without optimizer state: they
            # and the last epoch's moments would not make a consistent resume
            ckpt.save_checkpoint(f"{path}_best", est.best_params, None,
                                 step=0, epoch=est.best_epoch, sparse=deeplight)
            print(f"saved checkpoint: {path}_best (epoch {est.best_epoch + 1})")
    loss, auc, prauc, rce = est.eval_by_batch(xi[:n_test], xv[:n_test], y[:n_test])
    rep = sparsity_report(est.params)
    groups = deepfwfm.param_group_counts(est.params, mcfg, nonzero=True)
    total = deepfwfm.param_group_counts(est.params, mcfg, nonzero=False)
    out = {
        "mode": "deeplight" if deeplight else "dense",
        "test_logloss": round(loss, 4), "test_auc": round(auc, 4),
        "prauc": round(prauc, 4), "rce": round(rce, 2),
        "sparsity_pct": round(rep["sparsity_pct"], 2),
        "nonzero_params": rep["nonzero"],
        "dnn_sparsity_pct": round(100 * (1 - groups["dnn"] / max(total["dnn"], 1)), 1),
        "emb_sparsity_pct": round(100 * (1 - groups["second_order_embeddings"]
                                         / max(total["second_order_embeddings"], 1)), 1),
        "valid_auc_by_epoch": [round(v, 4) for v in est.valid_result],
        "train_wall_s": round(wall, 1),
    }
    if qat:
        # QAT at scale: the fake-quant-trained model converted to true int8
        # (the reference's fit(quantization_aware=True), then convert at eval)
        # and served, its AUC beside the fp eval's
        pred = Predictor(convert(est.params, mcfg, mode="qat"), device=device)
        logits = []
        for lo in range(0, n_test, SERVE_BATCH):
            logits.append(pred.logits(xi[lo:min(lo + SERVE_BATCH, n_test)],
                                      xv[lo:min(lo + SERVE_BATCH, n_test)]))
        p_int8 = 1.0 / (1.0 + np.exp(-np.concatenate(logits).astype(np.float64)))
        out["mode"] = "qat"
        out["int8_test_auc"] = round(M.roc_auc(
            np.asarray(y[:n_test], np.float64), p_int8), 4)
        if args.save:
            est.save(f"{args.save}_quant_aware", epoch=tcfg.n_epochs - 1)
            print(f"saved checkpoint: {args.save}_quant_aware")

    # test metrics at the best-valid epoch (the reference's per-epoch
    # checkpoints allow recovering it)
    if est.best_params is not None:
        final = est.params
        est.params = _tree.tree_map(lambda t: t.to(device), est.best_params)
        bl, ba, _, _ = est.eval_by_batch(xi[:n_test], xv[:n_test], y[:n_test])
        brep = sparsity_report(est.params)
        est.params = final
        out.update({"best_epoch": est.best_epoch + 1,
                    "best_test_auc": round(ba, 4),
                    "best_test_logloss": round(bl, 4),
                    "best_sparsity_pct": round(brep["sparsity_pct"], 2)})
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=2, help="dense-run epochs")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr-only", action="store_true")
    ap.add_argument("--steps-per-call", type=int, default=10,
                    help="train steps a dispatch (one CUDA graph replay on the card)")
    ap.add_argument("--full-criteo-dims", action="store_true",
                    help="use the full paper-scale cardinalities of --shape")
    ap.add_argument("--shape", choices=list(SHAPES), default="criteo",
                    help="dataset shape: criteo (39f/13num/1.33M) or "
                         "avazu (23f/1num/~1.5M)")
    ap.add_argument("--emb-size", type=int, default=10,
                    help="embedding dim (paper: 10 criteo / 20 avazu)")
    ap.add_argument("--deep-nodes", type=int, default=400,
                    help="tower width (paper: 400 criteo / 300 avazu)")
    ap.add_argument("--l2", type=float, default=3e-7,
                    help="L2 (paper: 3e-7 criteo / 6e-7 avazu)")
    ap.add_argument("--sparse", type=float, default=0.9)
    ap.add_argument("--emb-r", type=float, default=0.444)
    ap.add_argument("--emb-corr", type=float, default=1.0)
    ap.add_argument("--deeplight", action="store_true",
                    help="run the paper's prune recipe (D-90/R-90/F-40)")
    ap.add_argument("--qat", action="store_true",
                    help="quantization-aware training (fake-quant deep MLP); "
                         "converts to true int8 after fit and records both AUCs")
    ap.add_argument("--table-dtype", choices=["f32", "bf16"], default="f32",
                    help="table+moment storage dtype (-table_dtype flag)")
    ap.add_argument("--compare", action="store_true",
                    help="run dense AND deeplight on the same data; report gap")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--prune-epochs", type=int, default=8)
    ap.add_argument("--prune-omega", type=float, default=100.0)
    ap.add_argument("--eval-train-rows", type=int, default=0,
                    help="cap rows for the per-epoch train-metric eval (0 = all)")
    ap.add_argument("--min-count", type=int, default=4,
                    help="long-tail cutoff: expected-count threshold below "
                         "which ranks map to 0 (reference freq<4 rule)")
    ap.add_argument("--cache", default="",
                    help="npz path to cache/reuse the generated dataset")
    ap.add_argument("--save", default="",
                    help="checkpoint path prefix; saves <save>_dense / "
                         "<save>_deeplight after each arm")
    return ap


def main(argv=None, device: DeviceLike = None):
    """Returns (oracle test AUC, the runs' dicts, the compare summary or None),
    after printing them as the script does."""
    args = get_parser().parse_args(argv)
    device = resolve_device(device)
    if args.compare:
        # the dense baseline gets the same total epoch budget as the prune run
        args.epochs = args.warm + args.prune_epochs

    t0 = time.time()
    if args.cache and os.path.exists(args.cache):
        xi, xv, y, feature_sizes, logit, kept = load_cache(args.cache)
        assert len(y) == args.rows, f"cache has {len(y)} rows, want {args.rows}"
        print(f"loaded cached dataset {args.cache}")
    else:
        xi, xv, y, feature_sizes, logit, kept = make_synthetic(
            args.rows, args.seed, args.full_criteo_dims,
            min_count=args.min_count, shape=args.shape)
        if args.cache:
            save_cache(args.cache, xi, xv, y, logit, feature_sizes, kept)
    n_test = max(args.rows // 10, 1000)
    ceiling = oracle_auc(logit[:n_test], y[:n_test])
    print(f"generated {args.rows:,} rows in {time.time()-t0:.0f}s; "
          f"ctr={y.mean():.3f}; features={sum(feature_sizes):,} "
          f"({kept:,} above the freq threshold); "
          f"oracle test AUC (planted-model ceiling) = {ceiling:.4f}")

    runs = []
    modes = [False, True] if args.compare else [args.deeplight]
    for deeplight in modes:
        res = train_one(xi, xv, y, feature_sizes, n_test, args,
                        deeplight=deeplight, device=device)
        res.update({"rows": args.rows, "oracle_auc": round(ceiling, 4)})
        runs.append(res)
        print(json.dumps(res), flush=True)
    summary = None
    if len(runs) == 2:
        gap = runs[0]["test_auc"] - runs[1]["test_auc"]
        summary = {"dense_vs_sparse_auc_gap": round(gap, 4),
                   "dense_auc": runs[0]["test_auc"],
                   "sparse_auc": runs[1]["test_auc"],
                   "sparse_total_sparsity_pct": runs[1]["sparsity_pct"]}
        if "best_test_auc" in runs[0] and "best_test_auc" in runs[1]:
            summary["best_epoch_gap"] = round(
                runs[0]["best_test_auc"] - runs[1]["best_test_auc"], 4)
            summary["dense_best_auc"] = runs[0]["best_test_auc"]
            summary["sparse_best_auc"] = runs[1]["best_test_auc"]
            summary["sparse_best_sparsity_pct"] = runs[1]["best_sparsity_pct"]
        print(json.dumps(summary), flush=True)
    return ceiling, runs, summary


if __name__ == "__main__":
    main()
