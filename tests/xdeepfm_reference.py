"""xDeepFM in plain PyTorch, for the port's CPU tests: the forward, the
training-mode forward with dropout and Adam+L2 steps, in float32.

The tests' own copy of ``port_bench/reference/xdeepfm.py`` (the test suite
does not import the benchmark). From Lian et al., "xDeepFM", KDD 2018, Eq. 6
to 9, with X⁰ the (m, D) field embeddings:

    X^k_{h,d} = Σ_{i ≤ H_{k-1}} Σ_{j ≤ m} W^k_{h,i,j} X^{k-1}_{i,d} X⁰_{j,d},   H_0 = m
    p⁺ = [Σ_d X¹_{·,d}, ..., Σ_d X^L_{·,d}]
    logit = bias + Σ_f w_f(x) + w_cin · p⁺ + DNN(X⁰ flat)

No bias and no activation in the CIN. Field f's row is ``offset_f +
clip(index, 0, size_f - 1)``; a numeric field has one row, scaled by its
value. The DNN: inverted dropout on its input and after each ReLU layer, each
one uniform draw of the activation's shape from the generator, then a
bias-free head. Weights are a dict of the port's checkpoint names
(``cin/layers/{k-1}/w`` as (H_k, H_{k-1}·m), ``cin/fc_w``, ``emb1/dense``).
Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected in float32, L2 added to the
gradient first, the tables' subnormal first moments flushed. Imports torch
alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def rows(cfg: Dict, xi: torch.Tensor) -> torch.Tensor:
    sizes = torch.tensor(cfg["feature_sizes"], dtype=torch.long)
    off = torch.cumsum(sizes, 0) - sizes
    num = cfg["numerical"]
    cat = torch.minimum(xi.long().clamp(min=0), sizes[num:] - 1) + off[num:]
    return torch.cat([off[:num].expand(xi.shape[0], num), cat], dim=1)


def embed(cfg: Dict, table: torch.Tensor, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    scale = torch.cat([xv.float(), xv.new_ones((xv.shape[0], len(cfg["feature_sizes"])
                                                 - cfg["numerical"]))], dim=1)
    return table[rows(cfg, xi)] * scale[..., None]


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen) < 1.0 - rate
    return torch.where(keep, x / torch.tensor(1.0 - rate), torch.zeros_like(x))


def cin(w: Dict[str, torch.Tensor], x0: torch.Tensor, layers: int) -> torch.Tensor:
    m = x0.shape[1]
    h, pooled = x0, []
    for k in range(layers):
        wk = w[f"cin/layers/{k}/w"]
        z = h[:, :, None, :] * x0[:, None, :, :]                   # (B, H_{k-1}, m, D)
        h = torch.einsum("bimd,him->bhd", z, wk.reshape(wk.shape[0], -1, m))
        pooled.append(h.sum(dim=2))
    return torch.cat(pooled, dim=1)


def forward(w: Dict[str, torch.Tensor], cfg: Dict, xi: torch.Tensor, xv: torch.Tensor,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    x0 = embed(cfg, w["emb2/dense"], xi, xv)
    linear = embed(cfg, w["emb1/dense"], xi, xv)[..., 0].sum(dim=1)
    p = cin(w, x0, len(cfg["cin_layers"]))
    rate = cfg["dropout_deep"]
    x = dropout(x0, rate, gen).reshape(x0.shape[0], -1)
    for i in range(cfg["h_depth"]):
        x = dropout(torch.relu(x @ w[f"deep/net_1/layers/{i}/w"] + w[f"deep/net_1/layers/{i}/b"]),
                    rate, gen)
    return w["bias"][0] + linear + (p @ w["cin/fc_w"])[:, 0] + (x @ w["deep/net_1/fc_w"])[:, 0]


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()


def grads(w: Dict[str, torch.Tensor], cfg: Dict, batch: Dict[str, torch.Tensor],
          gen: Optional[torch.Generator]):
    """(loss, the gradient of every leaf without L2)."""
    live = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    loss = bce(forward(live, cfg, batch["xi"], batch["xv"], gen), batch["y"])
    return float(loss.detach()), dict(zip(live, torch.autograd.grad(loss, list(live.values()))))


def steps(w0: Dict[str, torch.Tensor], cfg: Dict, batches: List[Dict[str, torch.Tensor]],
          gen: torch.Generator):
    """(the losses, the weights after one Adam+L2 step a batch)."""
    w = {k: v.clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses = []
    for t, batch in enumerate(batches, start=1):
        loss, g = grads(w, cfg, batch, gen)
        c1, c2 = (1 - torch.tensor(b, dtype=torch.float32) ** t for b in (B1, B2))
        with torch.no_grad():
            for k, p in w.items():
                gk = g[k] + cfg["weight_decay"] * p
                mu[k].mul_(B1).add_(gk, alpha=1 - B1)
                if k.startswith(("emb1/", "emb2/")):
                    mu[k].masked_fill_(mu[k].abs() < torch.finfo(torch.float32).tiny, 0)
                nu[k].mul_(B2).addcmul_(gk, gk, value=1 - B2)
                p.add_((mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS), alpha=-cfg["learning_rate"])
        losses.append(loss)
    return losses, w
