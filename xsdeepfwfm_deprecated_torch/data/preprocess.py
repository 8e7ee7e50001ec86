"""Offline dataset preprocessing: raw logs → index-mapped CSV + feature map.
The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/preprocess.py``; numpy
and the standard library, with ``pandas`` frames passed in by the caller.

Vectorized counterparts of the reference's per-dataset scripts
(``data/large/preprocess_criteo.py``, ``preprocess_avazu.py``,
``preprocess_ali.py``, ``preprocess_twitter.py`` and the near-duplicate copies
under ``preprocess/``). Same statistical pipeline, numpy/pandas instead of
row loops:

Criteo (``data/large/preprocess_criteo.py``):
* split the raw ``train.txt`` into train / valid / test — the last day is
  split randomly 50/50 into valid/test (``:32-51``);
* numeric scaling: ``x > 2 → int(log(x)²)`` (``:54-60``);
* categorical frequency counting; values with freq < ``cutoff`` (=4) map to
  index 0 (long-tail bucket), others get 1..K per field in frequency order of
  first appearance; emit the ``field,raw_value,index`` feature map
  (``:62-117``);
* valid/test imputed with the train map, unknown → 0 (``:141-156``).

Avazu / Ali (``preprocess_avazu.py:20-45``, ``preprocess_ali.py:30-55``):
value-counts-rank mapping per categorical column.

Twitter (``data/large/preprocess_twitter.py:44-126``): min-max scaling of the
11 dense features, frequency threshold 8, parquet output.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def scale_numeric(value: float) -> float:
    """Criteo numeric scaling: ``x > 2 → int(log(x)²)`` (reference
    ``data/large/preprocess_criteo.py:54-60``)."""
    if value == "" or value is None:
        return 0.0
    v = float(value)
    if v > 2:
        return float(int(math.log(v) ** 2))
    return v


def build_frequency_maps(rows: Sequence[Sequence[str]], n_numeric: int,
                         cutoff: int = 4) -> List[Dict[str, int]]:
    """Per-categorical-field maps raw → index; freq < cutoff → dropped (index
    0 at lookup). Index order: first-appearance among surviving values
    (reference ``:80-117``)."""
    counters: Optional[List[Counter]] = None
    for row in rows:
        cats = row[n_numeric:]
        if counters is None:
            counters = [Counter() for _ in cats]
        for c, v in zip(counters, cats):
            c[v] += 1
    assert counters is not None
    maps: List[Dict[str, int]] = []
    for c in counters:
        m: Dict[str, int] = {}
        for v, freq in c.items():
            if freq >= cutoff and v != "":
                m[v] = len(m) + 1       # 0 reserved for long tail / unknown
        maps.append(m)
    return maps


def preprocess_criteo(raw_path: str, out_dir: str, *, cutoff: int = 4,
                      n_numeric: int = 13, n_fields: int = 39,
                      valid_test_fraction: float = 0.1, seed: int = 0,
                      max_rows: Optional[int] = None) -> Tuple[str, str, str, str]:
    """Raw tab-separated Criteo ``train.txt`` → mapped train/valid/test CSVs +
    feature map. Returns the four output paths.

    Split: the trailing ``valid_test_fraction`` of rows (the "last day" proxy)
    is divided randomly 50/50 into valid/test (reference ``:32-51``).
    """
    os.makedirs(out_dir, exist_ok=True)
    rows: List[List[str]] = []
    with open(raw_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            label = parts[0]
            nums = [str(scale_numeric(x) if x != "" else 0.0)
                    for x in parts[1:1 + n_numeric]]
            cats = parts[1 + n_numeric:1 + n_fields]
            cats += [""] * (n_fields - n_numeric - len(cats))
            rows.append([label] + nums + cats)

    n = len(rows)
    n_tail = max(2, int(n * valid_test_fraction))
    train_rows = rows[: n - n_tail]
    tail = rows[n - n_tail:]
    rng = np.random.default_rng(seed)
    mask = rng.random(len(tail)) < 0.5
    valid_rows = [r for r, m in zip(tail, mask) if m]
    test_rows = [r for r, m in zip(tail, mask) if not m]

    maps = build_frequency_maps([r[1:] for r in train_rows], n_numeric, cutoff)

    def write_mapped(path: str, subset: List[List[str]]):
        with open(path, "w") as f:
            for r in subset:
                cats = [str(maps[j].get(v, 0)) for j, v in enumerate(r[1 + n_numeric:])]
                f.write(",".join([r[0]] + r[1:1 + n_numeric] + cats) + "\n")

    p_train = os.path.join(out_dir, "criteo_train.csv")
    p_valid = os.path.join(out_dir, "criteo_valid.csv")
    p_test = os.path.join(out_dir, "criteo_test.csv")
    p_map = os.path.join(out_dir, "criteo_feature_map")
    write_mapped(p_train, train_rows)
    write_mapped(p_valid, valid_rows)
    write_mapped(p_test, test_rows)
    with open(p_map, "w") as f:
        for field_idx, m in enumerate(maps):
            # overall 1-based field position (categoricals follow the 13
            # numerics) to match feature_dim_start=1 readers
            pos = field_idx + n_numeric + 1
            for raw, idx in m.items():
                f.write(f"{pos},{raw},{idx}\n")
    return p_train, p_valid, p_test, p_map


def preprocess_value_counts(df, cat_columns: Sequence[str], cutoff: int = 4):
    """Avazu/Ali-style value_counts-rank mapping (reference
    ``data/large/preprocess_avazu.py:20-45``, ``preprocess_ali.py:30-55``):
    values are ranked by frequency; sub-cutoff values collapse to 0."""
    maps = {}
    for col in cat_columns:
        vc = df[col].value_counts()
        keep = vc[vc >= cutoff]
        mapping = {v: i + 1 for i, v in enumerate(keep.index)}
        maps[col] = mapping
        df[col] = df[col].map(mapping).fillna(0).astype(np.int64)
    return df, maps


def min_max_scale(df, columns: Sequence[str]):
    """Twitter dense-feature min-max scaling (reference
    ``data/large/preprocess_twitter.py:44-60``)."""
    for col in columns:
        lo, hi = df[col].min(), df[col].max()
        rng = (hi - lo) or 1.0
        df[col] = (df[col] - lo) / rng
    return df


ALI_DENSE_FEATURES = ("price", "time_stamp")


def preprocess_ali_join(raw_sample_df, ad_feature_df, user_profile_df,
                        out_path: Optional[str] = None):
    """Ali three-table join: raw_sample ⋈ user_profile ⋈ ad_feature →
    the ``ali_click.csv`` training table (reference
    ``data/large/ali_ad.py:18-110``).

    Reference semantics, step for step:

    * ``raw_sample.user`` renamed to ``userid``; inner-join user_profile on
      ``userid``, then ad_feature on ``adgroup_id`` (``:52,:85-86``);
    * history echo columns ``hist_cate_id``/``hist_adgroup_id`` copied from
      ``cate_id``/``adgroup_id`` (``:88-89``);
    * ``clk`` moved to column 0 (``:91-92``);
    * dense features ``price``/``time_stamp`` fillna(0) + min-max scaled to
      [0, 1], then inserted after ``clk`` — loop-insertion at position 1
      leaves the order ``clk, time_stamp, price`` (``:95-105``);
    * ``nonclk`` dropped (``:108``).

    The reference's dtype-downcast passes (``:31-81``) are a host-memory
    optimization with no effect on the written CSV and are skipped.
    Returns the joined DataFrame; ``out_path`` writes the header-less CSV the
    value-counts mapping step (:func:`preprocess_value_counts`) consumes.
    """
    df = raw_sample_df.rename(columns={"user": "userid"})
    df = df.merge(user_profile_df, on="userid")
    df = df.merge(ad_feature_df, on="adgroup_id")
    df["hist_cate_id"] = df["cate_id"]
    df["hist_adgroup_id"] = df["adgroup_id"]
    df.insert(0, "clk", df.pop("clk"))
    dense = list(ALI_DENSE_FEATURES)
    df[dense] = df[dense].fillna(0)
    df = min_max_scale(df, dense)
    for col in dense:
        df.insert(1, col, df.pop(col))
    df.pop("nonclk")
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        df.to_csv(out_path, header=None, index=None)
    return df


def preprocess_twitter(df, *, dense_features: Sequence[str],
                       sparse_features: Sequence[str],
                       label_cols: Sequence[str] = ("reply", "retweet",
                                                    "retweet_comment", "like"),
                       cutoff: int = 8, valid_fraction: float = 0.1,
                       test_fraction: float = 0.1, seed: int = 0,
                       out_dir: Optional[str] = None):
    """Twitter/RecSys preprocessing (reference ``data/large/preprocess_twitter.py``):
    min-max scale the dense features, frequency-threshold (cutoff 8) map the
    sparse features, random train/valid/test split, optional parquet output.

    Returns (train_df, valid_df, test_df, feature_maps). Column order in the
    output matches the reader contract: labels, dense, sparse.
    """
    df = df.copy()
    df = min_max_scale(df, dense_features)
    df, maps = preprocess_value_counts(df, sparse_features, cutoff=cutoff)

    rng = np.random.default_rng(seed)
    u = rng.random(len(df))
    test_mask = u < test_fraction
    valid_mask = (~test_mask) & (u < test_fraction + valid_fraction)
    train_mask = ~(test_mask | valid_mask)
    cols = list(label_cols) + list(dense_features) + list(sparse_features)
    train_df = df.loc[train_mask, cols]
    valid_df = df.loc[valid_mask, cols]
    test_df = df.loc[test_mask, cols]

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        train_df.to_parquet(os.path.join(out_dir, "twitter_train_s.parquet"))
        valid_df.to_parquet(os.path.join(out_dir, "twitter_valid_s.parquet"))
        test_df.to_parquet(os.path.join(out_dir, "twitter_test_s.parquet"))
        n_dense = len(dense_features)
        with open(os.path.join(out_dir, "twitter_feature_map_s"), "w") as f:
            # entries land at cate_dict[pos-4] for the reader's
            # feature_dim_start=4; sparse fields follow the dense block
            for j, col in enumerate(sparse_features):
                pos = n_dense + j + 4
                for raw, idx in maps[col].items():
                    f.write(f"{pos},{raw},{idx}\n")
    return train_df, valid_df, test_df, maps
