"""xDeepFM's operations and bytes, worked out from its configuration's shapes.

Nothing here reads the program. Per example, with m fields, D the embedding
width, H_0 = m and H_k the CIN's feature maps:

* the CIN: 2·D·Σ_k H_{k-1}·m·H_k (each map a weighted sum over the H_{k-1}·m
  products of a column, at every d);
* the DNN: 2·(m·D·h + (depth - 1)·h²);
* the heads: 2·(ΣH_k + h).

The outer products themselves (one multiply each) and the CIN's sum pooling
are left out, as elementwise work is everywhere here. The CIN forward's
compulsory bytes: X⁰ read once, each W_k read once, each X^k written once and
each X^{k-1} of a later layer read once, all float32; the materialized outer
product is not counted, so the yardstick measures the same work whatever
computes it. The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

from typing import Dict

from .roofline import FP32_FLOPS, HBM_BYTES_PER_S


def _maps(cfg: Dict):
    return [cfg["field_size"]] + list(cfg["cin_layers"])


def cin_flops(cfg: Dict) -> int:
    """The CIN forward's operations for one example."""
    m, d, maps = cfg["field_size"], cfg["embedding_size"], _maps(cfg)
    return 2 * d * sum(hp * m * hk for hp, hk in zip(maps[:-1], maps[1:]))


def dnn_flops(cfg: Dict) -> int:
    m, e, h, depth = cfg["field_size"], cfg["embedding_size"], cfg["deep_nodes"], cfg["h_depth"]
    return 2 * (m * e * h + (depth - 1) * h * h)


def head_flops(cfg: Dict) -> int:
    return 2 * (sum(cfg["cin_layers"]) + cfg["deep_nodes"])


def forward_flops(cfg: Dict) -> int:
    """One example's forward: the CIN, the DNN and the two heads."""
    return cin_flops(cfg) + dnn_flops(cfg) + head_flops(cfg)


def train_step_flops(cfg: Dict, batch: int) -> int:
    """A training step: the forward and a backward of twice its operations."""
    return 3 * forward_flops(cfg) * batch


def cin_bytes(cfg: Dict, batch: int) -> int:
    """The CIN forward's compulsory bytes at ``batch`` examples."""
    m, d, maps = cfg["field_size"], cfg["embedding_size"], _maps(cfg)
    weights = sum(hk * hp * m for hp, hk in zip(maps[:-1], maps[1:]))
    written = sum(maps[1:]) * d * batch
    reread = sum(maps[1:-1]) * d * batch
    return 4 * (batch * m * d + weights + written + reread)


def cin_least_seconds(cfg: Dict, batch: int) -> float:
    """The larger of the CIN forward's operations at the float32 peak and its
    bytes at HBM bandwidth."""
    return max(cin_flops(cfg) * batch / FP32_FLOPS, cin_bytes(cfg, batch) / HBM_BYTES_PER_S)


def param_count(cfg: Dict) -> int:
    """The two tables, the CIN and its head, the DNN with its biases and head,
    and the bias."""
    m, e, h, depth = cfg["field_size"], cfg["embedding_size"], cfg["deep_nodes"], cfg["h_depth"]
    maps = _maps(cfg)
    rows = sum(cfg["feature_sizes"])
    cin = sum(hk * hp * m for hp, hk in zip(maps[:-1], maps[1:])) + sum(cfg["cin_layers"])
    dnn = m * e * h + (depth - 1) * h * h + depth * h + h
    return rows * (1 + e) + cin + dnn + 1
