"""DeepFwFM's training step and DeepLight's prune refresh in plain PyTorch.

The step: the training-mode forward (``model.forward`` with a dropout
generator), the mean binary cross-entropy of the logits, its gradients by
autograd, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on the
gradient plus L2 (``weight_decay * w``, added before the moments). A table's
first moment is flushed to zero where it is subnormal, as XLA computes.

The refresh (DeepLight, section 4.2): at the schedule's sparsity ``s``, the
second-order table is thresholded as one group at ``s * emb_r``, each hidden
weight of the tower and the fwlw weights each at ``s``, and R at
``s * emb_corr`` on its symmetric part ``(R + R^T)/2``, zeroing R where that
part falls below. A group's threshold is the ``q``-quantile of its magnitudes
(linear interpolation between order statistics, as ``numpy.percentile``);
values below it become 0, and a target of 0 prunes nothing.

Imports torch and the reference's model alone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import model

B1, B2, EPS = 0.9, 0.999, 1e-8
TABLES = ("emb2/",)


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean of max(x, 0) - x y + log(1 + exp(-|x|))."""
    return (logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()


def grads(w: model.Weights, cfg: Dict, batch: Dict[str, torch.Tensor], gen: torch.Generator,
          precision: str) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, gradient of every leaf without L2)."""
    live = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    loss = bce(model.forward(live, cfg, batch["xi"], batch["xv"], precision=precision, gen=gen),
               batch["y"])
    g = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, g))


@torch.no_grad()
def adam_(w: model.Weights, g: Dict[str, torch.Tensor], state: Dict, lr: float) -> None:
    """One Adam update of ``w`` in place; ``g`` includes L2."""
    t = state["t"] = state.get("t", 0) + 1
    device = next(iter(w.values())).device
    # the bias corrections in float32, the configuration's precision
    c1, c2 = (1 - torch.tensor(b, dtype=torch.float32, device=device) ** t for b in (B1, B2))
    for k, p in w.items():
        mu = state.setdefault(("mu", k), torch.zeros_like(p))
        nu = state.setdefault(("nu", k), torch.zeros_like(p))
        mu.mul_(B1).add_(g[k], alpha=1 - B1)
        if k.startswith(TABLES):
            mu.masked_fill_(mu.abs() < torch.finfo(mu.dtype).tiny, 0)
        nu.mul_(B2).addcmul_(g[k], g[k], value=1 - B2)
        p.add_((mu / c1) / ((nu / c2).sqrt() + EPS), alpha=-lr)


def leaf_norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in ts.items()}


def steps(w0: model.Weights, cfg: Dict, batches: List[Dict[str, torch.Tensor]],
          gen: torch.Generator, precision: str = "fp32") -> Dict:
    """Train a copy of ``w0`` over ``batches``: the readings the program's run
    is held to. ``losses`` of every step; ``grad`` the norm of each leaf's
    first gradient with L2, as the optimizer gets it; ``change`` the norm of
    each leaf's change over all the steps."""
    model.no_tf32()
    w = {k: v.clone() for k, v in w0.items()}
    state: Dict = {}
    losses, first = [], None
    for batch in batches:
        loss, g = grads(w, cfg, batch, gen, precision)
        g = {k: g[k] + cfg["weight_decay"] * w[k] for k in w}
        if first is None:
            first = leaf_norms(g)
        adam_(w, g, state, cfg["learning_rate"])
        losses.append(loss)
    change = leaf_norms({k: w[k] - w0[k] for k in w})
    return {"losses": losses, "grad": first, "change": change}


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of x's values, linear between order statistics."""
    v = torch.sort(x.reshape(-1)).values
    pos = q * (v.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def _cut(x: torch.Tensor, target: float) -> torch.Tensor:
    """The magnitude threshold of x at ``target``: 0 for a target of 0."""
    if target <= 0.0:
        return torch.zeros((), device=x.device)
    return quantile(x.abs(), min(target, 1.0))


@torch.no_grad()
def refresh(w: model.Weights, cfg: Dict, target: float) -> model.Weights:
    """One prune refresh at schedule value ``target``: a new weight dict."""
    out = dict(w)
    if cfg.get("prune_fm", True):
        t = w["emb2/dense"]
        out["emb2/dense"] = torch.where(t.abs() < _cut(t, target * cfg["emb_r"]),
                                        torch.zeros_like(t), t)
    if cfg.get("prune_deep", True):
        names = [f"deep/net_1/layers/{i}/w" for i in range(cfg["h_depth"])] + ["fwlw_w"]
        for k in names:
            out[k] = torch.where(w[k].abs() < _cut(w[k], target), torch.zeros_like(w[k]), w[k])
    if cfg.get("prune_r", False):
        r = w["field_cov"]
        sym = 0.5 * (r + r.T)
        out["field_cov"] = torch.where(sym.abs() < _cut(sym, target * cfg["emb_corr"]),
                                       torch.zeros_like(r), r)
    return out


def pruned_names(cfg: Dict) -> List[str]:
    names: List[str] = []
    if cfg.get("prune_fm", True):
        names.append("emb2/dense")
    if cfg.get("prune_deep", True):
        names += [f"deep/net_1/layers/{i}/w" for i in range(cfg["h_depth"])] + ["fwlw_w"]
    if cfg.get("prune_r", False):
        names.append("field_cov")
    return names


def schedule(cfg: Dict, n_iter: int) -> float:
    """DeepLight's s_t = S (1 - D^(t / Omega))."""
    return cfg["sparse"] * (1.0 - cfg["prune_damping"] ** (n_iter / cfg["prune_omega"]))
