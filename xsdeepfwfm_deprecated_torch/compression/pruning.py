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
elements; above it a bisection of the value range in 40 halvings. On the CPU
(and for the sharded table) each halving is a pass over the array
(:func:`_bisect`); on the card one CUDA kernel searches every such group of
the tree at once, 8 halvings a pass, and zeroes in place
(``ops/cuda/prune_search``), to the same threshold bit for bit. Either way
the search stays on the tensor's device, so a refresh reads no value back
to the host. A refresh writes the zeros into the tree's own tensors
(:func:`prune_params_`); :func:`prune_params` does so on a copy.

On a mesh (``prune_params(..., mesh=...)``) the dense table is this rank's
row block, and its threshold is still global over the real rows: the
bisection all-reduces its maximum (MAX) and each halving's count (SUM) over
the table's ranks, so it is the unsharded search to the bit; below
``BISECT_SIZE`` the real rows are gathered and the quantile taken as
unsharded. Every other leaf is identical on every rank and pruned locally.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .. import _tree
from ..config import ModelConfig
from ..device import exact_div
from ..models import deepfwfm
from ..ops.cuda.prune_search import prune_search
from ..parallel.mesh import MODEL_AXIS, Axes, Mesh

BISECT_SIZE = 1 << 14
BISECT_ITERS = 40

Target = Union[float, torch.Tensor]
# one magnitude threshold: (leaf, leading values counted) pairs, every leaf zeroed whole
Search = Tuple[List[Tuple[torch.Tensor, int]], torch.Tensor]


def _bisect_threshold(absw: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """:func:`_bisect` over one array of magnitudes."""
    return _bisect(lambda v: torch.count_nonzero(absw < v), absw.max(), absw.numel(), target)


def _bisect(count_below: Callable[[torch.Tensor], torch.Tensor], amax: torch.Tensor, n: int,
            target: torch.Tensor) -> torch.Tensor:
    """Halve [lo, hi] on the pruned fraction ``count_below(mid) / n`` against
    the target, in LOG-magnitude space. ``amax`` is the largest magnitude;
    ``count_below(v)`` counts the magnitudes below ``v`` (across the blocks of
    a row-sharded table, too: integer counts make the search the same).

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
    hi = amax.clamp(min=1e-30).log()
    lo = hi + (-120.0 * 0.6931472)      # hi * 2^-120
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = count_below(mid.exp()).to(torch.float32)
        go_up = exact_div(below, float(n)) < target
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


def _sharded_table_threshold(tables: Dict[str, torch.Tensor], target: torch.Tensor,
                             dense_rows: int, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """:func:`magnitude_threshold` over the real rows of a dense table whose
    row blocks are spread over the ranks of ``axes``, together with the
    replicated QR tables, as if the whole table were on this rank."""
    block = tables["dense"]
    real = min(max(dense_rows - mesh.axis_index(axes) * block.shape[0], 0), block.shape[0])
    own = block[:real].reshape(-1).abs().to(torch.float32)
    rest = torch.cat([t.reshape(-1).abs().to(torch.float32) for k, t in tables.items()
                      if k != "dense"] + [own.new_zeros(0)])
    n = dense_rows * block.shape[1] + rest.numel()
    if n <= BISECT_SIZE:
        full = mesh.all_gather(block, axes).reshape(-1, block.shape[1])[:dense_rows]
        return magnitude_threshold(torch.cat([full.reshape(-1).to(torch.float32), rest]), target)
    target = target.clamp(0.0, 1.0)

    def count_below(v: torch.Tensor) -> torch.Tensor:
        return (mesh.all_reduce(torch.count_nonzero(own < v), axes)
                + torch.count_nonzero(rest < v))

    amax = mesh.all_reduce(own.max() if own.numel() else own.new_zeros(()), axes,
                           op=dist.ReduceOp.MAX)
    if rest.numel():
        amax = torch.maximum(amax, rest.max())
    thr = _bisect(count_below, amax, n, target)
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


def _apply_threshold_(w: torch.Tensor, threshold: torch.Tensor) -> None:
    """:func:`apply_threshold` in place."""
    w.masked_fill_(w.abs().to(threshold.dtype) < threshold, 0)


def _kernel_takes(leaf: torch.Tensor) -> bool:
    """Whether a search over ``leaf`` runs the CUDA kernel: on the card."""
    return leaf.device.type == "cuda"


def _search_(searches: List[Search]) -> None:
    """Each search's threshold, with its leaves zeroed below it in place: one
    kernel for every search on the card above ``BISECT_SIZE`` values, and
    :func:`magnitude_threshold` for the rest."""
    card, rest = [], []
    for search in searches:
        segments = search[0]
        big = sum(n for _, n in segments) > BISECT_SIZE
        (card if big and _kernel_takes(segments[0][0]) else rest).append(search)
    if card:
        prune_search([segments for segments, _ in card], [target for _, target in card])
    for segments, target in rest:
        thr = magnitude_threshold(
            torch.cat([leaf.reshape(-1)[:n].to(torch.float32) for leaf, n in segments]), target)
        for leaf, _ in segments:
            _apply_threshold_(leaf, thr)


@torch.no_grad()
def prune_params_(params: Dict, adaptive_sparse: Target, *,
                  emb_r: float = 1.0, emb_corr: float = 1.0,
                  prune_fm: bool = True, prune_deep: bool = True,
                  prune_r: bool = False, dense_rows: int = 0,
                  structured_deep: bool = False, mesh: Optional[Mesh] = None,
                  table_axes: Axes = MODEL_AXIS) -> None:
    """One prune refresh over the parameter tree, written into ``params``' own
    tensors, which the optimizer state, a captured CUDA graph and the caller
    keep referring to (``DeepFMEstimator.fit`` refreshes this way).

    ``dense_rows``: true row count of the packed ``dense`` table, for a table
    that was padded with zero rows: the threshold is then taken over the real
    rows only.

    ``mesh``: the ``dense`` tables are this rank's row blocks over the ranks
    of ``table_axes`` (``dense_rows`` then required); the embedding threshold
    is the whole table's. Every rank of the mesh calls it together.

    ``structured_deep`` prunes whole hidden units by the L2 norm of their
    weight column, on the same schedule, and zeroes the unit's bias with it,
    so that compaction can shrink the tower into a smaller dense one.

    DLRM-DCNv2's parameters (a ``bags`` group) are refused: the refresh
    prunes one-hot tables, R and the tower, which it lacks."""
    if "bags" in params:
        raise ValueError("the prune refresh does not take use_dlrm: DeepLight prunes one-hot "
                         "tables, FwFM's R and the tower, which DLRM-DCNv2 lacks")
    adaptive = _as_scalar(adaptive_sparse, _tree.leaves(params)[0])
    searches: List[Search] = []

    if prune_fm and "emb2" in params:
        tables = params["emb2"]
        if mesh is not None:
            thr = _sharded_table_threshold(tables, adaptive * emb_r, dense_rows, mesh, table_axes)
            for t in tables.values():
                _apply_threshold_(t, thr)
        else:
            searches.append(([(t, (t[:dense_rows] if k == "dense" and dense_rows
                                   and t.shape[0] > dense_rows else t).numel())
                              for k, t in tables.items()], adaptive * emb_r))

    if prune_deep:
        if "deep" in params:
            # the DeepFwFM family keeps named nets; NFM's "deep" is one net, without a head
            nets = [params["deep"]] if "layers" in params["deep"] else params["deep"].values()
            for net in nets:
                for layer in net["layers"]:
                    w, b = layer["w"], layer["b"]
                    if structured_deep:
                        norms = (w * w).sum(dim=0).sqrt()       # per unit
                        dead = norms < magnitude_threshold(norms, adaptive)
                        w.masked_fill_(dead[None, :], 0)
                        b.masked_fill_(dead, 0)
                    else:
                        searches.append(([(w, w.numel())], adaptive))
        if "fwlw_w" in params:
            searches.append(([(params["fwlw_w"], params["fwlw_w"].numel())], adaptive))

    if prune_r and "field_cov" in params:
        r = params["field_cov"]
        sym = 0.5 * (r + r.T)
        r.masked_fill_(sym.abs() < magnitude_threshold(sym, adaptive * emb_corr), 0)

    _search_(searches)


@torch.no_grad()
def prune_params(params: Dict, adaptive_sparse: Target, **kw) -> Dict:
    """:func:`prune_params_` on a copy of the tree: returns the pruned tree,
    with every key in the input's order (the optimizer state is matched to the
    parameters by leaf order); the input's tensors are left as they were."""
    out = _tree.tree_map(torch.clone, params)
    prune_params_(out, adaptive_sparse, **kw)
    return out


def make_masks(params: Dict, cfg: ModelConfig) -> Dict:
    """0/1 masks of the current sparsity pattern (for serving-time sparse
    kernels and checkpoint metadata; training zeroes in place)."""
    return _tree.tree_map(lambda p: (p != 0).to(p.dtype), params)


def sparsity_report(params: Dict) -> Dict[str, float]:
    """Total and non-zero parameter counts, with one copy from the device."""
    total, nonzero = deepfwfm.param_count(params), deepfwfm.nonzero_param_count(params)
    return {"total": total, "nonzero": nonzero,
            "sparsity_pct": 100.0 * (1.0 - nonzero / max(total, 1))}
