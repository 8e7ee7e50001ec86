"""Dataset readers: CSV / parquet → numpy arrays.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/readers.py``, the
counterpart of reference ``utils/data_preprocess.py`` (``read_data``
``:54-72``, ``read_data_twitter`` ``:29-51``, ``read_data_ali/avazu``
``:75-117``). The reference builds Python lists row by row; here we vectorize
with numpy/pandas and return a dict of dense arrays ready for device transfer:

    {"label": float32 (N,), "index": int32 (N, C), "value": float32 (N, Nnum),
     "feature_sizes": list[int]}

where C = categorical field count and Nnum = numeric field count.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .feature_map import feature_sizes_from_map, load_category_index

Batch = Dict[str, np.ndarray]

LAST_READER = ""   # "native" or "numpy": which parser read the last CSV


def _finalize(label, value, index, feature_sizes) -> Batch:
    return {
        "label": np.ascontiguousarray(label, dtype=np.float32),
        "value": np.ascontiguousarray(value, dtype=np.float32),
        "index": np.ascontiguousarray(index, dtype=np.int32),
        "feature_sizes": list(int(s) for s in feature_sizes),
    }


def read_data(file_path: str, emb_file: Optional[str], num_list: Sequence[int],
              feature_dim_start: int = 0, dim: int = 39,
              skip_header: bool = False) -> Batch:
    """Criteo-style CSV: label, then numeric values at 1-based positions in
    ``num_list``, remaining columns categorical mapped indices.

    Parity with reference ``utils/data_preprocess.py:54-72``. If ``emb_file`` is
    None (missing-map case, e.g. tiny-criteo), feature sizes are derived from
    the data itself via max-index+1.

    Ingest runs through the native C++ loader (``native/dataloader``) when
    built — memory-mapped multithreaded parsing instead of ``np.loadtxt`` —
    falling back to numpy transparently. :data:`LAST_READER` names the one
    that read the last file.
    """
    num_set = sorted(set(num_list))
    n_num = len(num_set)
    label = value = index = None
    from . import native_loader
    # the native loader drops rows by the first-cell-numeric criterion, which
    # would ingest a NUMERIC header row — bypass it when skip_header is set
    if not skip_header and native_loader.available():
        try:
            label, value, index = native_loader.read_csv_arrays(file_path, num_set)
        except (RuntimeError, IOError, ValueError):
            label = None
    global LAST_READER
    LAST_READER = "native" if label is not None else "numpy"
    if label is None:
        data = np.loadtxt(file_path, delimiter=",", dtype=np.float64,
                          skiprows=1 if skip_header else 0)
        if data.ndim == 1:
            data = data[None, :]
        label = data[:, 0]
        num_cols = list(num_set)                   # 1-based column positions
        cat_cols = [i for i in range(1, data.shape[1]) if i not in set(num_cols)]
        value = data[:, num_cols]
        index = data[:, cat_cols].astype(np.int64)

    if emb_file is not None:
        cate_dict = load_category_index(emb_file, feature_dim_start, dim)
        feature_sizes = feature_sizes_from_map(cate_dict, num_set)
    else:
        feature_sizes = [1] * n_num + [int(m) + 1 for m in index.max(axis=0)]
    return _finalize(label, value, index, feature_sizes)


def read_data_ali(file_path: str, emb_file: str, num_list: Sequence[int],
                  feature_dim_start: int = 1, dim: int = 20) -> Batch:
    """Ali/Avazu CSV variant (reference ``:75-117``): same layout, skips a
    header row whose label cell is ``y2``, indices stored as floats. Uses the
    native C++ loader when built (non-numeric header rows are skipped by the
    same first-cell criterion)."""
    num_set = sorted(set(num_list))
    label = value = index = None
    from . import native_loader
    if native_loader.available():
        try:
            label, value, index = native_loader.read_csv_arrays(file_path, num_set)
        except (RuntimeError, IOError, ValueError):
            label = None
    global LAST_READER
    LAST_READER = "native" if label is not None else "numpy"
    if label is None:
        rows = []
        with open(file_path) as f:
            for line in f:
                parts = line.strip().split(",")
                if not parts or parts[0] == "y2":
                    continue
                rows.append([float(x) for x in parts])
        data = np.asarray(rows, dtype=np.float64)
        label = data[:, 0]
        num_cols = list(num_set)
        cat_cols = [i for i in range(1, data.shape[1]) if i not in set(num_cols)]
        value = data[:, num_cols]
        index = data[:, cat_cols].astype(np.int64)
    cate_dict = load_category_index(emb_file, feature_dim_start, dim)
    feature_sizes = feature_sizes_from_map(cate_dict, num_set)
    return _finalize(label, value, index, feature_sizes)


read_data_avazu = read_data_ali  # identical semantics (reference :98-117)


def read_data_twitter(file_path: str, emb_file: str, num_list: Sequence[int],
                      feature_dim_start: int = 0, dim: int = 39,
                      twitter_category: str = "like") -> Batch:
    """Twitter parquet variant (reference ``:29-51``): 4 engagement labels;
    keep only ``twitter_category``; numeric columns 1..len(num_list),
    categoricals after."""
    import pandas as pd
    cate_dict = load_category_index(emb_file, feature_dim_start, dim)
    feature_sizes = feature_sizes_from_map(cate_dict, num_list)

    data = pd.read_parquet(file_path)
    for label_col in ["reply", "retweet", "retweet_comment", "like"]:
        if label_col != twitter_category and label_col in data.columns:
            data = data.drop(columns=[label_col])
    label = data[twitter_category].to_numpy()
    n_num = len(num_list)
    value = data.iloc[:, list(range(1, n_num + 1))].to_numpy()
    index = data.iloc[:, list(range(n_num + 1, len(data.columns)))].to_numpy()
    return _finalize(label, value, index, feature_sizes)
