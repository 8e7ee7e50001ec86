"""Model-quality metrics: logloss, ROC-AUC, PR-AUC, RCE.

The port's own copy of ``xsdeepfwfm_deprecated_tpu/train/metrics.py``:
host-side float64 numpy implementations with sklearn-compatible semantics,
written from the metric definitions so that nothing depends on sklearn.
"""

from __future__ import annotations

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (Mann-Whitney U), average ranks on ties."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks over tied groups (1-based)
    base = np.arange(1, len(y_score) + 1, dtype=np.float64)
    boundaries = np.flatnonzero(np.diff(sorted_scores)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(y_score)]])
    for s, e in zip(starts, ends):
        ranks[order[s:e]] = 0.5 * (base[s] + base[e - 1])
    rank_sum = float(np.sum(ranks[y_true == 1]))
    return (rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    """sklearn-semantics PR curve: points at each distinct score threshold
    (descending), truncated once full recall is reached, with a final
    (precision=1, recall=0) endpoint."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    desc = np.argsort(-y_score, kind="mergesort")
    y_sorted = y_true[desc]
    s_sorted = y_score[desc]
    distinct = np.flatnonzero(np.diff(s_sorted))
    threshold_idxs = np.concatenate([distinct, [len(y_sorted) - 1]])
    tps = np.cumsum(y_sorted)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    denom = tps + fps
    precision = np.divide(tps, denom, out=np.zeros_like(tps), where=denom > 0)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    # truncate at first index achieving full recall, then reverse
    last_ind = int(np.searchsorted(tps, tps[-1]))
    sl = slice(last_ind, None, -1)
    precision = np.concatenate([precision[sl], [1.0]])
    recall = np.concatenate([recall[sl], [0.0]])
    thresholds = s_sorted[threshold_idxs][sl]
    return precision, recall, thresholds


def prauc(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Area under the PR curve by trapezoid over recall. Argument order
    matches the reference (predictions first)."""
    precision, recall, _ = precision_recall_curve(y_true, y_pred)
    # recall is decreasing → integrate on the reversed axis
    return float(np.trapezoid(precision[::-1], recall[::-1]))


def log_loss(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary cross entropy on probabilities, eps-clipped (sklearn semantics)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.clip(np.asarray(y_pred, dtype=np.float64).ravel(),
                np.finfo(np.float64).eps, 1.0 - np.finfo(np.float64).eps)
    return float(-np.mean(y_true * np.log(p) + (1.0 - y_true) * np.log(1.0 - p)))


def rce(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Relative cross entropy vs the constant-CTR strawman, times 100."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    ce = log_loss(y_true, y_pred)
    ctr = float(np.mean(y_true == 1))
    strawman = log_loss(y_true, np.full_like(y_true, ctr))
    return (1.0 - ce / strawman) * 100.0


def bce_logits_sum(y_true: np.ndarray, logits: np.ndarray) -> float:
    """Numerically stable sum of BCE-with-logits (loss accounting on the host)."""
    logits = np.asarray(logits, dtype=np.float64).ravel()
    y = np.asarray(y_true, dtype=np.float64).ravel()
    return float(np.sum(np.maximum(logits, 0) - logits * y + np.log1p(np.exp(-np.abs(logits)))))
