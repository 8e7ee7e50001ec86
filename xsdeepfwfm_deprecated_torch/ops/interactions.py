"""Pairwise-interaction ops: FM, FwFM, FFM in contraction form, xDeepFM's CIN
and DLRM-DCNv2's low-rank cross network.

Port of ``xsdeepfwfm_deprecated_tpu/ops/interactions.py:26-75``. None of the
pairwise ops materializes the ``(F, F, B, E)`` outer product. Float32 matmuls
run in full float32 (TF32 off, set by :func:`..device.resolve_device`), as the
JAX ops' ``precision="highest"``. :func:`cin_forward` and :func:`dcn_cross` are
the port's own (the JAX package has neither).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils import profiling as prof
from .cuda.cin import cin as cin_layer


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, E) → (B, E): ``0.5·((Σ_k e_k)² − Σ_k e_k²)``."""
    s = emb.sum(dim=1)
    sq = (emb * emb).sum(dim=1)
    return 0.5 * (s * s - sq)


def symmetrize(r: torch.Tensor) -> torch.Tensor:
    """R_sym = (R + Rᵀ)/2."""
    return 0.5 * (r + r.T)


def fwfm_second_order(emb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, F, E), (F, F) → (B, E):
    ``0.5·(Σ_{k,l} R_sym[k,l] e_k e_l − Σ_k R_sym[k,k] e_k²)``."""
    r_sym = symmetrize(r)
    m = torch.einsum("kl,ble->bke", r_sym, emb)          # Σ_l R_sym[k,l]·e_l
    pair = (emb * m).sum(dim=1)
    diag = (torch.diagonal(r_sym)[None, :, None] * emb * emb).sum(dim=1)
    return 0.5 * (pair - diag)


def fwfm_linear_term(emb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FwLW linear term from 2nd-order embeddings: (B,F,E),(F,E) → (B,F),
    ``Σ_e E[b,f,e]·W[f,e]``."""
    return torch.einsum("bfe,fe->bf", emb, w)


def ffm_second_order(emb_pairs: torch.Tensor) -> torch.Tensor:
    """FFM interaction: (B, F, F, E) → (B, E), ``Σ_{i<j} e_{i,j} ⊙ e_{j,i}``
    where ``emb_pairs[b,i,j]`` is field i's embedding for field j."""
    f = emb_pairs.shape[1]
    prod = emb_pairs * emb_pairs.transpose(1, 2)
    iu = torch.triu(torch.ones((f, f), dtype=emb_pairs.dtype, device=emb_pairs.device),
                    diagonal=1)
    return torch.einsum("bije,ij->be", prod, iu)


def cin_forward(x0: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """xDeepFM's Compressed Interaction Network (Lian et al., KDD 2018, Eq. 6
    to 8): (B, m, D) field embeddings X⁰ and one (H_k, H_{k-1}·m) matrix a
    layer → p⁺ (B, ΣH_k), the sum over D of every feature map of every layer.

    ``X^k[h, d] = Σ_{i,j} W^k[h, i·m + j] · X^{k-1}[i, d] · X⁰[j, d]``, with no
    bias and no activation; every map goes to the output and to the next
    layer. Over the rows r = (b, d) a layer is :func:`.cuda.cin.cin`, which
    holds the maps feature-major, (H_k, B·D), and on the card never forms the
    (B·D, H_{k-1}·m) outer product. Each layer is a span ``CIN - Layer {k}``."""
    b, m, d = x0.shape
    x0t = x0.permute(1, 0, 2).reshape(m, b * d)                  # X⁰ᵀ (m, B·D)
    h, pooled = x0t, []
    for k, w in enumerate(weights, start=1):
        with prof.named_scope(f"CIN - Layer {k}"):
            h = cin_layer(h, x0t, w)                             # X^kᵀ (H_k, B·D)
            pooled.append(h.view(-1, b, d).sum(dim=2).T)         # (B, H_k)
    return torch.cat(pooled, dim=1)


def dcn_cross(x0: torch.Tensor, layers: Sequence[dict]) -> torch.Tensor:
    """DCN V2's low-rank cross network (Wang et al., WWW 2021, sec. 3, Eq. 2
    with W = U·Vᵀ), as DLRM-DCNv2 runs it: (B, D) x₀ and one ``{"v": (r, D),
    "w": (D, r), "b": (D,)}`` a layer → x_L (B, D), where

        x_{l+1} = x₀ ⊙ (W_l (V_l x_l) + b_l) + x_l.

    Two GEMMs a layer, in float32; each layer is a span ``DCN - Layer {k}``."""
    x = x0
    for k, layer in enumerate(layers, start=1):
        with prof.named_scope(f"DCN - Layer {k}"):
            x = torch.addcmul(x, x0, torch.addmm(layer["b"], x @ layer["v"].T, layer["w"].T))
    return x
