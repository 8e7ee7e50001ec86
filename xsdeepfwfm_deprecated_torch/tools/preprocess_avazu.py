"""Avazu preprocessing CLI: value-counts-rank mapping, split and feature map.

Port of ``scripts/preprocess_avazu.py`` (the reference's
``data/large/preprocess_avazu.py``), with its arguments and printed line:
categorical columns mapped by value-counts rank with a frequency cutoff
(:func:`..data.preprocess.preprocess_value_counts`), a seeded 80/10/10
train/valid/test split and the ``field,raw,index`` feature map. It needs
``pandas`` (imported when it runs), runs on the host only and takes no
device.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.preprocess_avazu <raw.csv> <out_dir> [--cutoff 4]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.preprocess import preprocess_value_counts


def main(argv=None) -> None:
    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("raw_path")
    ap.add_argument("out_dir")
    ap.add_argument("--cutoff", type=int, default=4)
    ap.add_argument("--label-col", default="click")
    ap.add_argument("--numeric-cols", nargs="*", default=["hour"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    df = pd.read_csv(args.raw_path)
    cat_cols = [c for c in df.columns
                if c not in ([args.label_col] + args.numeric_cols + ["id"])]
    df, maps = preprocess_value_counts(df, cat_cols, cutoff=args.cutoff)

    rng = np.random.default_rng(args.seed)
    u = rng.random(len(df))
    splits = {"train": u < 0.8, "valid": (u >= 0.8) & (u < 0.9), "test": u >= 0.9}
    cols = [args.label_col] + args.numeric_cols + cat_cols
    for split, mask in splits.items():
        df.loc[mask, cols].to_csv(os.path.join(args.out_dir, f"avazu_{split}.csv"),
                                  index=False, header=False)
    n_num = len(args.numeric_cols)
    with open(os.path.join(args.out_dir, "avazu_feature_map"), "w") as f:
        for j, col in enumerate(cat_cols):
            pos = n_num + j + 1   # 1-based overall position after the numerics
            for raw, idx in maps[col].items():
                f.write(f"{pos},{raw},{idx}\n")
    print(os.path.join(args.out_dir, "avazu_feature_map"))


if __name__ == "__main__":
    main()
