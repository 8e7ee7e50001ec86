"""Feature-map handling: category-index files and ``feature_sizes`` derivation.
The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/feature_map.py``.

The reference keeps a per-dataset feature-map file with lines
``field,raw_value,mapped_index`` and derives ``feature_sizes`` as
``[1]*num_numeric + [len(map_f)+1 for each categorical field f]``
(reference ``utils/data_preprocess.py:18-26`` and ``:54-61``).

The snapshot is missing ``data/category_emb`` (the tiny-criteo map; see
``.MISSING_LARGE_BLOBS``), so this module can also regenerate feature sizes
directly from an already index-mapped CSV: the mapped indices for field f span
``0..len(map_f)`` (index 0 is the long-tail/unknown bucket), so
``feature_sizes[f] = max(index in column f) + 1`` reproduces the
``len(map)+1`` semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def load_category_index(file_path: str, feature_dim_start: int = 0, dim: int = 39) -> List[Dict[str, int]]:
    """Read a ``field,raw_value,mapped_index`` feature map into per-field dicts.

    Parity with reference ``utils/data_preprocess.py:18-26``.
    """
    cate_dict: List[Dict[str, int]] = [dict() for _ in range(dim)]
    with open(file_path, "r") as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 3:
                continue
            cate_dict[int(parts[0]) - feature_dim_start][parts[1]] = int(parts[2])
    return cate_dict


def feature_sizes_from_map(cate_dict: Sequence[Dict[str, int]], num_list: Sequence[int]) -> List[int]:
    """``[1]*num_numeric + [len(map)+1 for categorical fields]``.

    Parity with reference ``utils/data_preprocess.py:58-61``: a field ``f`` (1-based
    position ``f+1``) is categorical iff ``f+1 not in num_list``.
    """
    num_set = set(num_list)
    sizes = [1] * len(num_set)
    for num, item in enumerate(cate_dict):
        if num + 1 not in num_set:
            sizes.append(len(item) + 1)
    return sizes


def derive_feature_sizes_from_csv(paths: Sequence[str], num_numeric: int) -> List[int]:
    """Regenerate feature sizes for an already index-mapped CSV (no map file).

    Used for tiny-criteo whose ``data/category_emb`` map is missing from the
    reference snapshot. Columns: label, ``num_numeric`` numeric values, then
    categorical mapped indices. Scans the union of ``paths`` so evaluation rows
    never index out of table bounds.
    """
    maxima: Optional[np.ndarray] = None
    n_cols = None
    for path in paths:
        data = np.loadtxt(path, delimiter=",", dtype=np.int64)
        if n_cols is None:
            n_cols = data.shape[1]
        cat = data[:, 1 + num_numeric:]
        m = cat.max(axis=0)
        maxima = m if maxima is None else np.maximum(maxima, m)
    assert maxima is not None, "no input paths"
    return [1] * num_numeric + [int(x) + 1 for x in maxima]


def write_feature_map_stub(path: str, feature_sizes: Sequence[int], num_numeric: int) -> None:
    """Emit a ``field,raw_value,mapped_index`` file consistent with feature_sizes.

    For regenerated maps (identity raw→index), so downstream consumers of the
    reference file format keep working. Index 0 is reserved for the long-tail
    bucket (reference ``data/large/preprocess_criteo.py:80-117`` semantics), so
    each categorical field f emits entries 1..feature_sizes[f]-1.
    """
    with open(path, "w") as f:
        for field_idx, size in enumerate(feature_sizes):
            if field_idx < num_numeric:
                continue
            for idx in range(1, size):
                f.write(f"{field_idx},{idx},{idx}\n")
