"""The flagship model: DeepFwFM with lw+fwlw on Criteo-shaped fields.

The port's own copy of ``__graft_entry__._flagship`` and its cardinality list:
39 fields, 13 numeric, E=10, a 400x400x400 tower with a 1-unit head.
"""

from __future__ import annotations

from .config import ModelConfig, TrainConfig

# Full-Criteo categorical cardinalities: 1,326,042 categorical rows, plus the
# 13 single-row numeric slots = 1,326,055 packed rows.
FULL_CRITEO_CAT_SIZES = (
    1458, 556, 245197, 166166, 306, 20, 12055, 634, 4, 46330, 5229, 243454,
    3177, 27, 11745, 225322, 11, 4727, 2058, 5, 238640, 18, 16, 67856, 89,
    50942)

# tiny-criteo-like cardinalities, for small runs
TINY_CAT_SIZES = (
    83, 202, 78, 23, 201, 87, 51, 46, 71, 5, 24, 18, 37, 665, 511, 24186,
    27018, 172, 8, 8613, 330, 2, 14357, 4086, 24692, 2903)


def flagship_config(full_criteo: bool = True) -> ModelConfig:
    """The flagship DeepFwFM config; ``full_criteo=False`` uses the
    tiny-criteo cardinalities."""
    cat_sizes = FULL_CRITEO_CAT_SIZES if full_criteo else TINY_CAT_SIZES
    return ModelConfig(field_size=39, feature_sizes=(1,) * 13 + cat_sizes, numerical=13,
                       embedding_size=10, deep_nodes=400, h_depth=3, use_fwfm=True,
                       use_deep=True, use_lw=True, use_fwlw=True)


def flagship_train_config(**overrides) -> TrainConfig:
    """The reference's training defaults for the flagship: Adam, lr 1e-3,
    L2 3e-7, batches of 2,048, a prune refresh every 10 steps. Keyword
    arguments replace fields."""
    base = dict(optimizer_type="adam", learning_rate=1e-3, weight_decay=3e-7,
                batch_size=2048, prune_interval=10)
    base.update(overrides)
    return TrainConfig(**base)
