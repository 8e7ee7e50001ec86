"""xDeepFM in plain PyTorch: the fp32 forward, the training-mode forward with
dropout, and the Adam+L2 steps that the program's run is held to.

Written from Lian et al., "xDeepFM", KDD 2018, sections 3.2 to 3.4 (Eq. 6 to 9),
with X⁰ the (m, D) field embeddings of one example:

    X^k_{h,d} = Σ_{i ≤ H_{k-1}} Σ_{j ≤ m} W^k_{h,i,j} X^{k-1}_{i,d} X⁰_{j,d},   k = 1..L, H_0 = m
    p^k_h = Σ_d X^k_{h,d};   p⁺ = [p¹, ..., p^L]
    logit = bias + Σ_f w_f(x) + w_cin · p⁺ + DNN(X⁰ flat)

The CIN has no bias and no activation (Eq. 6), and every map of every layer
goes to the output and to the next layer. The linear part is one scalar a
feature (``emb1/dense``), a numeric field's row times its value. The DNN is
ReLU layers with dropout at ``dropout_deep`` on its (B, m, D) input and after
each hidden layer, drawn in that order, and a bias-free head. Weights are a
dict of the checkpoint names: ``cin/layers/{k-1}/w`` is W^k as (H_k, H_{k-1}·m),
column i·m + j for the pair (i, j); ``cin/fc_w`` is w_cin, (ΣH_k, 1).

``precision`` ``fp32`` computes in float32 with TF32 off; ``tf32`` rounds both
operands of every product to TF32 first (``model._ops``). Imports torch and the
reference's DeepFwFM helpers alone: nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import model, train

TABLES = ("emb1/", "emb2/")     # the leaves whose first moments are flushed, as XLA computes


def cin(w: model.Weights, x0: torch.Tensor, layers: int, einsum) -> torch.Tensor:
    """p⁺ (B, ΣH_k) of the CIN on X⁰ (B, m, D)."""
    m = x0.shape[1]
    h, pooled = x0, []
    for k in range(layers):
        wk = w[f"cin/layers/{k}/w"]
        z = h[:, :, None, :] * x0[:, None, :, :]            # (B, H_{k-1}, m, D): Eq. 6's products
        h = einsum("bimd,him->bhd", z, wk.reshape(wk.shape[0], -1, m))
        pooled.append(h.sum(dim=2))
    return torch.cat(pooled, dim=1)


def forward(w: model.Weights, cfg: Dict, xi: torch.Tensor, xv: torch.Tensor, *,
            precision: str = "fp32", gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits (B,). With ``gen`` the training-mode forward: the DNN's dropout
    drawn from ``gen``."""
    einsum = model._ops(precision)
    x0 = model.embed(cfg, w["emb2/dense"], xi, xv)                       # (B, m, D)
    linear = model.embed(cfg, w["emb1/dense"], xi, xv)[..., 0].sum(dim=1)
    p = cin(w, x0, len(cfg["cin_layers"]), einsum)
    rate = cfg["dropout_deep"]
    x = model._dropout(x0, rate, gen).reshape(x0.shape[0], -1)
    for wt, b in model._layers(w, cfg["h_depth"]):
        x = model._dropout(torch.relu(einsum("bi,io->bo", x, wt) + b), rate, gen)
    deep = einsum("bi,io->bo", x, w["deep/net_1/fc_w"])[:, 0]
    return w["bias"][0] + linear + einsum("bh,ho->bo", p, w["cin/fc_w"])[:, 0] + deep


def grads(w: model.Weights, cfg: Dict, batch: Dict[str, torch.Tensor], gen: torch.Generator,
          precision: str):
    """(loss, gradient of every leaf without L2)."""
    live = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    loss = train.bce(forward(live, cfg, batch["xi"], batch["xv"], precision=precision, gen=gen),
                     batch["y"])
    g = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, g))


@torch.no_grad()
def adam_(w: model.Weights, g: Dict[str, torch.Tensor], state: Dict, lr: float) -> None:
    """``train.adam_`` with both tables' first moments flushed where subnormal."""
    t = state["t"] = state.get("t", 0) + 1
    device = next(iter(w.values())).device
    c1, c2 = (1 - torch.tensor(b, dtype=torch.float32, device=device) ** t
              for b in (train.B1, train.B2))
    for k, p in w.items():
        mu = state.setdefault(("mu", k), torch.zeros_like(p))
        nu = state.setdefault(("nu", k), torch.zeros_like(p))
        mu.mul_(train.B1).add_(g[k], alpha=1 - train.B1)
        if k.startswith(TABLES):
            mu.masked_fill_(mu.abs() < torch.finfo(mu.dtype).tiny, 0)
        nu.mul_(train.B2).addcmul_(g[k], g[k], value=1 - train.B2)
        p.add_((mu / c1) / ((nu / c2).sqrt() + train.EPS), alpha=-lr)


def steps(w0: model.Weights, cfg: Dict, batches: List[Dict[str, torch.Tensor]],
          gen: torch.Generator, precision: str = "fp32") -> Dict:
    """Train a copy of ``w0`` over ``batches``, as ``train.steps``: ``losses``
    of every step, ``grad`` the norm of each leaf's first gradient with L2,
    ``change`` the norm of each leaf's change over all the steps."""
    model.no_tf32()
    w = {k: v.clone() for k, v in w0.items()}
    state: Dict = {}
    losses, first = [], None
    for batch in batches:
        loss, g = grads(w, cfg, batch, gen, precision)
        g = {k: g[k] + cfg["weight_decay"] * w[k] for k in w}
        if first is None:
            first = train.leaf_norms(g)
        adam_(w, g, state, cfg["learning_rate"])
        losses.append(loss)
    return {"losses": losses, "grad": first,
            "change": train.leaf_norms({k: w[k] - w0[k] for k in w})}
