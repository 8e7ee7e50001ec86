"""Ali preprocessing CLI: the reference's two-stage Ali pipeline.

Port of ``scripts/preprocess_ali.py``, with its subcommands, arguments and
printed lines:

* ``join``: ``raw_sample.csv`` + ``ad_feature.csv`` + ``user_profile.csv`` to
  ``ali_click.csv``, the three-table inner join of the reference's
  ``data/large/ali_ad.py:18-110`` (:func:`..data.preprocess.preprocess_ali_join`);
* ``map``: a joined table to a value-counts-rank index mapping built on the
  train split, with the reference's split fractions (sample 50%, train/test
  90/10, valid 30% of train; ``data/large/preprocess_ali.py:63-72``), writing
  ``ali_{train,valid,test}.csv`` and ``ali_feature_map``.

It needs ``pandas`` (imported when it runs), runs on the host only and takes
no device.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.preprocess_ali join <raw_sample.csv> \\
      <ad_feature.csv> <user_profile.csv> <out_dir>
  python -m xsdeepfwfm_deprecated_torch.tools.preprocess_ali map <joined.csv> <out_dir> \\
      [--n-dense 10] [--cutoff 1] [--sample-frac 0.5]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.preprocess import preprocess_ali_join, preprocess_value_counts


def cmd_join(args, pd) -> None:
    raw_sample = pd.read_csv(args.raw_sample)
    ad_feature = pd.read_csv(args.ad_feature)
    user_profile = pd.read_csv(args.user_profile)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "ali_click.csv")
    df = preprocess_ali_join(raw_sample, ad_feature, user_profile, out_path=out)
    print(f"{out}: {len(df)} rows, {len(df.columns)} cols")


def cmd_map(args, pd) -> None:
    df = pd.read_csv(args.joined, header=None if args.no_header else "infer",
                     index_col=None, low_memory=False)
    df.columns = range(len(df.columns))   # positional: label, dense..., cats...
    cat_cols = list(df.columns[1 + args.n_dense:])

    # the reference's split (preprocess_ali.py:63-72): sample, then 90/10, then 70/30
    rng = np.random.default_rng(args.seed)
    df = df.sample(frac=args.sample_frac, random_state=args.seed).reset_index(drop=True)
    u = rng.random(len(df))
    test = df[u >= 0.9]
    train_raw = df[u < 0.9]
    v = rng.random(len(train_raw))
    valid = train_raw[v < 0.3]
    train = train_raw[v >= 0.3].reset_index(drop=True)

    # maps built on the train split only; valid/test imputed, unknown -> 0
    train = train.copy().fillna(0)
    train, maps = preprocess_value_counts(train, cat_cols, cutoff=args.cutoff)

    os.makedirs(args.out_dir, exist_ok=True)
    for name, part in (("train", train), ("valid", valid), ("test", test)):
        part = part.copy().fillna(0)
        if name != "train":
            for col in cat_cols:
                part[col] = part[col].map(maps[col]).fillna(0).astype(np.int64)
        part.to_csv(os.path.join(args.out_dir, f"ali_{name}.csv"),
                    header=False, index=False)
    with open(os.path.join(args.out_dir, "ali_feature_map"), "w") as f:
        # 1-based overall field positions after the dense block (the reference
        # writes positions 11..40 for n_dense=10, :49-55)
        for j, col in enumerate(cat_cols):
            pos = args.n_dense + j + 1
            for raw, idx in maps[col].items():
                f.write(f"{pos},{raw},{idx}\n")
    print(os.path.join(args.out_dir, "ali_feature_map"))


def main(argv=None) -> None:
    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="stage", required=True)
    j = sub.add_parser("join")
    j.add_argument("raw_sample")
    j.add_argument("ad_feature")
    j.add_argument("user_profile")
    j.add_argument("out_dir")
    j.set_defaults(fn=cmd_join)
    m = sub.add_parser("map")
    m.add_argument("joined")
    m.add_argument("out_dir")
    m.add_argument("--n-dense", type=int, default=10)
    m.add_argument("--cutoff", type=int, default=1)
    m.add_argument("--sample-frac", type=float, default=0.5)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--no-header", action="store_true")
    m.set_defaults(fn=cmd_map)
    args = ap.parse_args(argv)
    args.fn(args, pd)


if __name__ == "__main__":
    main()
