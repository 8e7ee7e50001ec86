"""Pairwise-interaction ops: FM, FwFM, FFM in contraction form.

Port of ``xsdeepfwfm_deprecated_tpu/ops/interactions.py:26-75``. None of them
materializes the ``(F, F, B, E)`` outer product. Float32 matmuls run in full
float32 (TF32 off, set by :func:`..device.resolve_device`), as the JAX ops'
``precision="highest"``.
"""

from __future__ import annotations

import torch


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
