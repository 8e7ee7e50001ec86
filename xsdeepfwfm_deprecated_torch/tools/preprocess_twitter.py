"""Twitter / RecSys-2020 preprocessing CLI over :func:`..data.preprocess.preprocess_twitter`.

Port of ``scripts/preprocess_twitter.py`` (the reference's
``data/large/preprocess_twitter.py``), with its arguments and printed line:
min-max scaling of the dense engagement features, a frequency threshold
(cutoff 8) on the sparse ones, a seeded train/valid/test split, parquet
output and feature maps. It needs ``pandas`` (imported when it runs), runs on
the host only and takes no device.

Usage:
  python -m xsdeepfwfm_deprecated_torch.tools.preprocess_twitter <raw.(csv|parquet)> <out_dir> \\
      [--cutoff 8] [--dense-cols ...] [--sparse-cols ...]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import preprocess_twitter

# the reference's column layout (data/large/preprocess_twitter.py:20-43):
# 4 engagement labels, 11 dense counters, 32 sparse/categorical fields
DEFAULT_LABELS = ["reply", "retweet", "retweet_comment", "like"]
DEFAULT_DENSE = ["photo", "video", "link", "domains", "hashtags",
                 "present_media", "present_links", "present_domains",
                 "tweet_len", "follower_count", "following_count"]


def main(argv=None) -> None:
    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("raw_path")
    ap.add_argument("out_dir")
    ap.add_argument("--cutoff", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label-cols", nargs="*", default=DEFAULT_LABELS)
    ap.add_argument("--dense-cols", nargs="*", default=DEFAULT_DENSE)
    ap.add_argument("--sparse-cols", nargs="*", default=None,
                    help="default: every remaining column")
    args = ap.parse_args(argv)

    if args.raw_path.endswith(".parquet"):
        df = pd.read_parquet(args.raw_path)
    else:
        df = pd.read_csv(args.raw_path)
    sparse = args.sparse_cols or [
        c for c in df.columns if c not in set(args.label_cols + args.dense_cols)]
    train_df, valid_df, test_df, maps = preprocess_twitter(
        df, dense_features=args.dense_cols, sparse_features=sparse,
        label_cols=tuple(args.label_cols), cutoff=args.cutoff, seed=args.seed,
        out_dir=args.out_dir)
    print(f"{args.out_dir}: train {len(train_df)} / valid {len(valid_df)} / "
          f"test {len(test_df)} rows, {len(sparse)} sparse fields")


if __name__ == "__main__":
    main()
