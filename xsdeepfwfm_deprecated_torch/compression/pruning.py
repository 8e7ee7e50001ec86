"""DeepLight structural pruning: magnitude pruning with the adaptive schedule.

Port of ``xsdeepfwfm_deprecated_tpu/compression/pruning.py``:

* schedule ``s_t = S * (1 - 0.99^(t/100))`` on the post-warm-up iteration
  count (``config.TrainConfig.adaptive_sparse``);
* three groups, each with its own rate:
  (a) ALL 2nd-order embedding tables thresholded **globally** at
      ``s_t * emb_r`` (dense, and the QR quotient and remainder tables);
  (b) every DNN hidden-layer weight **per layer** at ``s_t``, and the fwlw
      weight; biases and the fc head are not pruned;
  (c) the field matrix R, thresholded on its symmetrized half-sum at
      ``s_t * emb_corr`` and zeroed in place.
* weights are zeroed, masks are not kept: between refreshes the optimizer
  can regrow a pruned weight, so thresholds are recomputed at every refresh.

Threshold search: the exact ``torch.quantile(|w|, s)`` up to ``BISECT_SIZE``
elements; above it a bisection of the value range in 40 passes over the
array. The whole search stays on the tensor's device: the halvings choose
with ``torch.where`` on 0-d tensors, so a refresh reads no value back to
the host.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from .. import _tree
from ..config import ModelConfig
from ..device import exact_div
from ..models import deepfwfm

BISECT_SIZE = 1 << 14
BISECT_ITERS = 40

Target = Union[float, torch.Tensor]


def _bisect_threshold(absw: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Halve [lo, hi] on the pruned fraction ``mean(|w| < mid)`` against the
    target, in LOG-magnitude space.

    Embedding rows that no batch samples decay under Adam+L2 by a few percent
    a step (L2 is their only gradient and Adam normalizes it), so after a
    few hundred steps they cluster at |w| ~ 1e-18..1e-31. A linear search of
    40 halvings cannot resolve below ``max * 2^-40 ~ 5e-13``: every threshold
    it can return lies above that cluster and wipes it whole. Halving
    [max * 2^-120, max] geometrically reaches any normal float32 threshold in
    the same 40 passes.

    The pruned fraction is ``count_nonzero / n``: an integer count, exact at
    any size, where a float32 mean of 0/1 values is exact only up to 2^24
    elements."""
    hi = absw.max().clamp(min=1e-30).log()
    lo = hi + (-120.0 * 0.6931472)      # hi * 2^-120
    n = float(absw.numel())
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = torch.count_nonzero(absw < mid.exp()).to(torch.float32)
        go_up = exact_div(below, n) < target
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    return (0.5 * (lo + hi)).exp()


def magnitude_threshold(w: torch.Tensor, target_sparsity: Target) -> torch.Tensor:
    """|w| value below which ``target_sparsity`` of the entries fall, as a
    0-d tensor on ``w``'s device. A zero target gives threshold 0.0 exactly
    (prune nothing): a searched threshold would be tiny but positive, and
    would wipe the rows that Adam+L2 parked at |w| ~ 1e-31."""
    target = _as_scalar(target_sparsity, w).clamp(0.0, 1.0)
    absw = w.detach().reshape(-1).abs().to(torch.float32)
    thr = (_bisect_threshold(absw, target) if absw.numel() > BISECT_SIZE
           else torch.quantile(absw, target))
    return torch.where(target > 0.0, thr, torch.zeros_like(thr))


def _as_scalar(value: Target, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device, made by a fill (no copy
    from the host, so nothing waits for the device)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def apply_threshold(w: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Zero the entries with |w| < threshold. The comparison is made in the
    threshold's float32, for bf16 tables too."""
    return torch.where(w.abs().to(threshold.dtype) < threshold, torch.zeros_like(w), w)


@torch.no_grad()
def prune_params(params: Dict, adaptive_sparse: Target, *,
                 emb_r: float = 1.0, emb_corr: float = 1.0,
                 prune_fm: bool = True, prune_deep: bool = True,
                 prune_r: bool = False, dense_rows: int = 0,
                 structured_deep: bool = False) -> Dict:
    """One prune refresh over the parameter tree. Returns the pruned tree,
    with every key in the input's order (the optimizer state is matched to the
    parameters by leaf order); the input's tensors are left as they were.

    ``dense_rows``: true row count of the packed ``dense`` table, for a table
    that was padded with zero rows: the threshold is then taken over the real
    rows only.

    ``structured_deep`` prunes whole hidden units by the L2 norm of their
    weight column, on the same schedule, and zeroes the unit's bias with it,
    so that compaction can shrink the tower into a smaller dense one."""
    params = dict(params)
    ref = _tree.leaves(params)[0]
    adaptive = _as_scalar(adaptive_sparse, ref)

    if prune_fm and "emb2" in params:
        tables = params["emb2"]
        flat = torch.cat([(t[:dense_rows] if k == "dense" and dense_rows
                           and t.shape[0] > dense_rows else t).reshape(-1).to(torch.float32)
                          for k, t in tables.items()])
        thr = magnitude_threshold(flat, adaptive * emb_r)
        del flat
        params["emb2"] = {k: apply_threshold(t, thr) for k, t in tables.items()}

    if prune_deep:
        if "deep" in params:
            new_deep = {}
            # the DeepFwFM family keeps named nets; NFM's "deep" is one net, without a head
            one_net = "layers" in params["deep"]
            nets = {"": params["deep"]} if one_net else params["deep"]
            for net_name, net in nets.items():
                layers = []
                for layer in net["layers"]:
                    w, b = layer["w"], layer["b"]
                    if structured_deep:
                        norms = (w * w).sum(dim=0).sqrt()       # per unit
                        dead = norms < magnitude_threshold(norms, adaptive)
                        layers.append({**layer,
                                       "w": torch.where(dead[None, :], torch.zeros_like(w), w),
                                       "b": torch.where(dead, torch.zeros_like(b), b)})
                    else:
                        layers.append({**layer,
                                       "w": apply_threshold(w, magnitude_threshold(w, adaptive))})
                new_deep[net_name] = {**net, "layers": layers}
            params["deep"] = new_deep[""] if one_net else new_deep
        if "fwlw_w" in params:
            w = params["fwlw_w"]
            params["fwlw_w"] = apply_threshold(w, magnitude_threshold(w, adaptive))

    if prune_r and "field_cov" in params:
        r = params["field_cov"]
        sym = 0.5 * (r + r.T)
        thr = magnitude_threshold(sym, adaptive * emb_corr)
        params["field_cov"] = torch.where(sym.abs() < thr, torch.zeros_like(r), r)

    return params


def make_masks(params: Dict, cfg: ModelConfig) -> Dict:
    """0/1 masks of the current sparsity pattern (for serving-time sparse
    kernels and checkpoint metadata; training zeroes in place)."""
    return _tree.tree_map(lambda p: (p != 0).to(p.dtype), params)


def sparsity_report(params: Dict) -> Dict[str, float]:
    """Total and non-zero parameter counts, with one copy from the device."""
    total, nonzero = deepfwfm.param_count(params), deepfwfm.nonzero_param_count(params)
    return {"total": total, "nonzero": nonzero,
            "sparsity_pct": 100.0 * (1.0 - nonzero / max(total, 1))}
