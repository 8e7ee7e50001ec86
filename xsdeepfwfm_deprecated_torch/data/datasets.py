"""Dataset registry: name → (field_size, train, valid, test) dicts.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/data/datasets.py``
(reference ``model/Datasets.py:24-84``). Same dataset
names and field layouts:

=========== ======= ========= ===========================================
dataset     fields  numeric   source files
=========== ======= ========= ===========================================
tiny-criteo 39      13        bundled ``data/tiny_{train,test}_input.csv``
criteo      39      13        ``data/large/criteo_{train,valid,test}.csv``
twitter     47      11        ``data/large/twitter_{train,valid,test}_s.parquet``
ali         32      10        ``data/large/ali_{train,valid,test}.csv``
avazu       23      1         ``data/large/avazu_{train,valid,test}.csv``
=========== ======= ========= ===========================================

The tiny-criteo feature map (``data/category_emb``) is missing from the
reference snapshot, so feature sizes are derived from the union of the bundled
train+test CSVs (max mapped index + 1 per categorical column, matching the
``len(map)+1`` semantics of ``utils/data_preprocess.py:58-61``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from . import readers
from .feature_map import derive_feature_sizes_from_csv

CRITEO_NUM_FEAT = list(range(1, 14))
TWITTER_NUM_FEAT = list(range(1, 12))
ALI_NUM_FEAT = list(range(1, 11))
AVAZU_NUM_FEAT = [1]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DATA_DIR = os.path.join(_REPO_ROOT, "data")


def get_dataset(dataset: str, data_dir: str = None, twitter_category: str = "like"
                ) -> Tuple[int, Dict, Dict, Dict]:
    """Load ``dataset`` → (field_size, train_dict, valid_dict, test_dict).

    Dict layout matches :mod:`readers` (dense numpy arrays). Like the reference
    (``model/Datasets.py:35-38``), tiny-criteo reuses its test file for both
    valid and test.
    """
    data_dir = data_dir or DEFAULT_DATA_DIR
    j = lambda *p: os.path.join(data_dir, *p)

    if dataset == "tiny-criteo":
        field_size = 39
        train_path, test_path = j("tiny_train_input.csv"), j("tiny_test_input.csv")
        sizes = derive_feature_sizes_from_csv([train_path, test_path], num_numeric=13)
        train = readers.read_data(train_path, None, CRITEO_NUM_FEAT, dim=field_size)
        test = readers.read_data(test_path, None, CRITEO_NUM_FEAT, dim=field_size)
        train["feature_sizes"] = sizes
        test["feature_sizes"] = sizes
        return field_size, train, dict(test), dict(test)

    if dataset == "criteo":
        field_size = 39
        emb = j("large", "criteo_feature_map")
        mk = lambda split: readers.read_data(j("large", f"criteo_{split}.csv"), emb,
                                             CRITEO_NUM_FEAT, feature_dim_start=1, dim=field_size)
        return field_size, mk("train"), mk("valid"), mk("test")

    if dataset == "twitter":
        field_size = 47
        emb = j("large", "twitter_feature_map_s")
        mk = lambda split: readers.read_data_twitter(
            j("large", f"twitter_{split}_s.parquet"), emb, TWITTER_NUM_FEAT,
            feature_dim_start=4, dim=field_size, twitter_category=twitter_category)
        return field_size, mk("train"), mk("valid"), mk("test")

    if dataset == "ali":
        field_size = 32
        emb = j("large", "ali_feature_map")
        mk = lambda split: readers.read_data_ali(j("large", f"ali_{split}.csv"), emb,
                                                 ALI_NUM_FEAT, feature_dim_start=1, dim=32)
        return field_size, mk("train"), mk("valid"), mk("test")

    if dataset == "avazu":
        field_size = 23
        emb = j("large", "avazu_feature_map")
        mk = lambda split: readers.read_data_ali(j("large", f"avazu_{split}.csv"), emb,
                                                 AVAZU_NUM_FEAT, feature_dim_start=1, dim=23)
        return field_size, mk("train"), mk("valid"), mk("test")

    raise ValueError(f"unknown dataset {dataset!r} "
                     "(choices: criteo, tiny-criteo, twitter, ali, avazu)")
