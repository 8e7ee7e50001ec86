"""NFM (Neural Factorization Machine) baseline.

Port of ``xsdeepfwfm_deprecated_tpu/models/nfm.py:43-162``, the counterpart of
the reference's standalone ``NFM.py``. Model structure (reference
``NFM.py:177-280``):

* 1st-order term: per-field scalar embeddings, numeric fields scaled by value;
* deep input:
  - ``interaction_type=True`` → **bi-interaction pooling** over the 2nd-order
    embeddings, ``0.5·((Σ_f e_f)² − Σ_f e_f²)`` → (B, E) (reference ``:200-210``);
  - ``interaction_type=False`` → pairwise scalar products
    ``[Σ_e e_i·e_j for i<j]`` → (B, F(F−1)/2) (reference ``:211-218``, ``:246-249``);
* MLP: a tower with NO output head — the logit adds the **sum of the last
  hidden layer** (reference ``:272-278``);
* logit = bias + Σ 1st-order + Σ x_deep.

The reference NFM never calls an init_weights: it relies on torch defaults
(Embedding ~ N(0,1); Linear ~ U(±1/√fan_in)), reproduced here. The parameter
tree is ``bias``, ``emb1``, ``emb2``, ``deep/layers/i/{w,b}``: no ``net_1``
and no ``fc_w``.

:class:`NFMEstimator` plugs the NFM forward into
:class:`..train.trainer.DeepFMEstimator` and adds the reference's ``refit``
mode (continue training on train+valid, ``NFM.py:393-432``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import DeviceLike, constant, resolve_device
from ..ops import embedding as emb_ops
from ..ops import interactions as inter_ops
from ..ops import mlp as mlp_ops
from ..train.trainer import DeepFMEstimator


@dataclass(frozen=True)
class NFMConfig(ModelConfig):
    """ModelConfig + NFM's extra knobs. ``use_fm`` marks the FM flavor
    (vs FFM); ``use_deep`` is implicitly True."""
    interaction_type: bool = True         # bi-interaction (True) vs pairwise concat
    deep_activation: str = "relu"         # relu | sigmoid | tanh (reference :252-257)
    sane_init: bool = False               # extension (-nfm_sane_init): scale the tables to
                                          # N(0, 0.01) like the DeepFwFM family instead of the
                                          # reference's torch-default N(0,1), whose
                                          # bi-interaction explodes to O(F·E) logits.
                                          # Default off = faithful to the reference.

    def __post_init__(self):
        # NFM composes differently; skip the FM-family mutual-exclusion check
        if len(self.feature_sizes) != self.field_size:
            raise ValueError("feature_sizes length mismatch")


def make_spec(cfg: NFMConfig) -> emb_ops.PackedEmbeddingSpec:
    return emb_ops.make_spec(cfg.feature_sizes, cfg.numerical)


def _uniform(generator: Optional[torch.Generator], shape, bound: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """U(-bound, bound) drawn on the CPU, so a seed gives the same values on
    every device; a shape-and-dtype template on the ``meta`` device."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    u = torch.rand(tuple(shape), generator=generator) * (2.0 * bound) - bound
    return u.to(dtype=dtype, device=device)


def init_params(generator: Optional[torch.Generator], cfg: NFMConfig,
                device: DeviceLike = None, dtype: torch.dtype = torch.float32) -> Dict:
    device = resolve_device(device)
    spec = make_spec(cfg)
    sane = getattr(cfg, "sane_init", False)
    scale = 0.01 if sane else 1.0
    if sane:
        bias = torch.tensor([0.01], dtype=dtype, device=device)
    elif device.type == "meta":
        bias = torch.empty((1,), dtype=dtype, device=device)
    else:
        bias = torch.randn((1,), generator=generator).to(dtype=dtype, device=device)  # :127
    params: Dict = {"bias": bias}
    params["emb1"] = emb_ops.init_tables(generator, spec, 1, scale, dtype, device)
    params["emb2"] = emb_ops.init_tables(generator, spec, cfg.embedding_size, scale,
                                         dtype, device)          # torch default N(0,1)
    f = cfg.field_size
    in_dim = cfg.embedding_size if cfg.interaction_type else f * (f - 1) // 2
    dims = [in_dim] + list(cfg.deep_layers)
    layers = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(fi)     # torch nn.Linear default init
        layers.append({"w": _uniform(generator, (fi, fo), bound, dtype, device),
                       "b": _uniform(generator, (fo,), bound, dtype, device)})
    params["deep"] = {"layers": layers}
    return params


def _activation(name: str):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh}.get(name, torch.relu)


def forward(params: Dict, xi: torch.Tensor, xv: torch.Tensor, cfg: NFMConfig, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            lookup_fn=None) -> torch.Tensor:
    spec = make_spec(cfg)
    lookup = lookup_fn or emb_ops.packed_lookup

    first_order = lookup(params["emb1"], spec, xi, xv)[..., 0]                  # (B, F)
    if cfg.is_shallow_dropout and cfg.dropout_shallow[0] > 0:
        first_order = mlp_ops.dropout(generator, first_order, cfg.dropout_shallow[0], train)

    emb2 = lookup(params["emb2"], spec, xi, xv)                                 # (B, F, E)
    if cfg.interaction_type:
        deep_in = inter_ops.fm_second_order(emb2)                               # (B, E)
    else:
        # pairwise scalars Σ_e e_i·e_j for i<j (reference :246-249)
        gram = torch.einsum("bie,bje->bij", emb2, emb2)
        iu, ju = np.triu_indices(cfg.field_size, k=1)
        flat = constant(tuple(int(i * cfg.field_size + j) for i, j in zip(iu, ju)),
                        torch.long, emb2.device)
        deep_in = gram.reshape(gram.shape[0], -1).index_select(1, flat)        # (B, F(F-1)/2)

    # deep tower: dropout0 → (linear → act → dropout)×depth, NO output head
    # NFM dropout profile: [0.0, 0.5, 0.5, 0.5] (reference :67)
    act = _activation(cfg.deep_activation)
    rates = ((0.0,) + (cfg.dropout_deep,) * cfg.h_depth if cfg.is_deep_dropout
             else (0.0,) * (cfg.h_depth + 1))
    x = mlp_ops.dropout(generator, deep_in, rates[0], train)
    for i, layer in enumerate(params["deep"]["layers"]):
        x = act(x @ layer["w"] + layer["b"])
        x = mlp_ops.dropout(generator, x, rates[i + 1], train)

    return params["bias"][0] + first_order.sum(dim=1) + x.sum(dim=1)


class NFMEstimator(DeepFMEstimator):
    """NFM with the framework's estimator surface + the reference's refit mode."""

    model_forward = staticmethod(forward)
    model_init = staticmethod(init_params)
    model_spec = staticmethod(make_spec)

    def fit(self, Xi, Xv, y, Xi_valid=None, Xv_valid=None, y_valid=None,
            *, refit: bool = False, **kw):
        super().fit(Xi, Xv, y, Xi_valid, Xv_valid, y_valid, **kw)
        if refit and Xi_valid is not None and len(Xi_valid) > 0:
            # reference NFM.py:393-432: continue on train+valid combined; the
            # parameters go on from where the first fit left them
            self._log("refitting the model")
            c = self.mcfg.num_categorical
            Xi_all = np.concatenate([np.asarray(Xi, np.int32).reshape(-1, c),
                                     np.asarray(Xi_valid, np.int32).reshape(-1, c)])
            Xv_all = np.concatenate([np.asarray(Xv, np.float32),
                                     np.asarray(Xv_valid, np.float32)])
            y_all = np.concatenate([np.asarray(y, np.float32).ravel(),
                                    np.asarray(y_valid, np.float32).ravel()])
            super().fit(Xi_all, Xv_all, y_all, [], [], [], **kw)
            self._log("refit finished")
        return self
