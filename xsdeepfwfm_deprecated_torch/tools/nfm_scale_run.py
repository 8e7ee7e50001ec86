"""NFM at synthetic scale: the ``sane_init`` arm and the faithful one.

Port of ``scripts/nfm_scale_run.py``, with its flags and JSON lines. The
reference's ``NFM.py`` never initializes its embeddings (torch's default
N(0,1)); bi-interaction pooling of N(0,1) vectors gives O(F*E) logits and the
model diverges, which the port reproduces by default. This shows that NFM
trains when given the ``sane_init`` extension: a 1M-row synthetic CTR run (the
rows of :func:`.synthetic_scale_run.make_synthetic`, random cardinalities)
reaching an AUC well above 0.5, with the faithful arm beside it
(``--faithful-too``).

Usage: python -m xsdeepfwfm_deprecated_torch.tools.nfm_scale_run [--rows 1000000] [--epochs 3]
"""

from __future__ import annotations

import argparse
import json
import time

from ..config import TrainConfig
from ..device import DeviceLike, resolve_device
from ..models.nfm import NFMConfig, NFMEstimator
from .synthetic_scale_run import SHAPES, make_synthetic, oracle_auc


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faithful-too", action="store_true",
                    help="also run the faithful (uninitialized) default arm")
    return ap


def main(argv=None, device: DeviceLike = None) -> list:
    """Returns the printed dict of each arm."""
    args = get_parser().parse_args(argv)
    device = resolve_device(device)

    xi, xv, y, feature_sizes, logit, kept = make_synthetic(
        args.rows, args.seed, full_dims=False, shape="criteo")
    n_test = max(args.rows // 10, 1000)
    ceiling = oracle_auc(logit[:n_test], y[:n_test])
    print(f"rows={args.rows:,} features={sum(feature_sizes):,} "
          f"oracle AUC={ceiling:.4f}")

    results = []
    arms = [True] + ([False] if args.faithful_too else [])
    for sane in arms:
        mcfg = NFMConfig(field_size=len(feature_sizes),
                         feature_sizes=tuple(feature_sizes),
                         numerical=SHAPES["criteo"][0], embedding_size=10,
                         h_depth=3, deep_nodes=64,
                         use_fm=True, use_deep=True, use_fwfm=False,
                         interaction_type=True, sane_init=sane)
        tcfg = TrainConfig(n_epochs=args.epochs, batch_size=args.batch,
                           learning_rate=1e-3, random_seed=args.seed,
                           steps_per_call=10, eval_train_rows=200_000)
        est = NFMEstimator(mcfg, tcfg, device=device)
        t0 = time.time()
        est.fit(xi[2 * n_test:], xv[2 * n_test:], y[2 * n_test:],
                xi[n_test:2 * n_test], xv[n_test:2 * n_test],
                y[n_test:2 * n_test])
        loss, auc, prauc, rce = est.eval_by_batch(
            xi[:n_test], xv[:n_test], y[:n_test])
        res = {
            "arm": "sane_init" if sane else "faithful-default",
            "rows": args.rows, "epochs": args.epochs,
            "test_logloss": round(loss, 4), "test_auc": round(auc, 4),
            "oracle_auc": round(ceiling, 4),
            "valid_auc_by_epoch": [round(v, 4) for v in est.valid_result],
            "train_wall_s": round(time.time() - t0, 1)}
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
