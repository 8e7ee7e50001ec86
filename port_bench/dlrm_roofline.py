"""DLRM-DCNv2's operations and bytes, worked out from its configuration's shapes.

Nothing here reads the program. Per example, with C bags of width E, D =
(1 + C)·E, r the cross layers' rank and L their number:

* the dense arch, the cross network and the over arch: 2 FLOP a multiply-add
  of their matrices (``forward_flops``); a training step is the forward and
  a backward of twice its operations;
* the cross network alone: 2 GEMMs a layer of D·r multiply-adds each.

The bags' compulsory bytes take the batch's distinct rows, which the
benchmark counts from its own batches (never from the program):

* the lookup: every id (4 B) read, each distinct row read once, the pooled
  bags (B·C·E float32) written;
* the update: the bags' gradient read, every id read, each distinct row's
  weights and Adagrad accumulator read and written once (4 row-widths).

So a row that many bags share counts once, and a share cannot pass 100%
where L2 serves a zipf-hot row. The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

from typing import Dict

from .roofline import FP32_FLOPS, HBM_BYTES_PER_S


def _bags(cfg: Dict) -> int:
    return cfg["field_size"] - cfg["numerical"]


def cross_width(cfg: Dict) -> int:
    return (1 + _bags(cfg)) * cfg["embedding_size"]


def _macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def dense_arch_macs(cfg: Dict) -> int:
    return _macs([cfg["numerical"]] + list(cfg["dense_arch_layers"]))


def cross_macs(cfg: Dict) -> int:
    return cfg["dcn_num_layers"] * 2 * cross_width(cfg) * cfg["dcn_low_rank_dim"]


def over_arch_macs(cfg: Dict) -> int:
    return _macs([cross_width(cfg)] + list(cfg["over_arch_layers"]))


def forward_flops(cfg: Dict) -> int:
    """One example's forward."""
    return 2 * (dense_arch_macs(cfg) + cross_macs(cfg) + over_arch_macs(cfg))


def train_step_flops(cfg: Dict, batch: int) -> int:
    return 3 * forward_flops(cfg) * batch


def dcn_least_seconds(cfg: Dict, batch: int) -> float:
    """The cross network's forward at the float32 peak."""
    return 2 * cross_macs(cfg) * batch / FP32_FLOPS


def _row_bytes(cfg: Dict) -> int:
    return 4 * cfg["embedding_size"]


def ids(cfg: Dict, batch: int) -> int:
    return batch * sum(cfg["bag_sizes"])


def lookup_bytes(cfg: Dict, batch: int, distinct_rows: float) -> float:
    return 4 * ids(cfg, batch) + _row_bytes(cfg) * (distinct_rows + batch * _bags(cfg))


def update_bytes(cfg: Dict, batch: int, distinct_rows: float) -> float:
    return (_row_bytes(cfg) * (batch * _bags(cfg) + 4 * distinct_rows) + 4 * ids(cfg, batch))


def lookup_least_seconds(cfg: Dict, batch: int, distinct_rows: float) -> float:
    return lookup_bytes(cfg, batch, distinct_rows) / HBM_BYTES_PER_S


def update_least_seconds(cfg: Dict, batch: int, distinct_rows: float) -> float:
    return update_bytes(cfg, batch, distinct_rows) / HBM_BYTES_PER_S


def param_count(cfg: Dict) -> int:
    """The table, both arches with their biases and the cross layers."""
    d, r = cross_width(cfg), cfg["dcn_low_rank_dim"]
    arch_biases = sum(cfg["dense_arch_layers"]) + sum(cfg["over_arch_layers"])
    table = sum(cfg["feature_sizes"][cfg["numerical"]:]) * cfg["embedding_size"]
    return (table + dense_arch_macs(cfg) + over_arch_macs(cfg) + arch_biases
            + cfg["dcn_num_layers"] * (2 * d * r + d))
