"""DLRM-DCNv2, MLPerf Training's recommendation model, as plain functions on a
dict of tensors (the port's own; the JAX package has no such model).

Naumov et al., "Deep Learning Recommendation Model", 2019, with the
interaction replaced by the low-rank cross network of Wang et al., "DCN V2",
WWW 2021, sec. 3, as the MLCommons training reference
``recommendation_v2/torchrec_dlrm`` builds it:

* the dense arch: the ``numerical`` values through ``dense_arch_layers``,
  ReLU after each layer, to one row of ``embedding_size``;
* the bags: categorical field f is ``bag_sizes[f]`` ids whose rows of the
  packed table are summed (:func:`..ops.embedding.bag_lookup`); a numeric
  field has no rows;
* the cross network: x₀ = [dense row, the bags] flattened, (B, (1 + C)·E),
  through ``dcn_num_layers`` low-rank layers of rank ``dcn_low_rank_dim``
  (:func:`..ops.interactions.dcn_cross`);
* the over arch: ``over_arch_layers``, ReLU after each but the last, whose
  one unit, with its bias, is the logit.

Leaves: ``bags/dense`` (rows, E); ``dense_arch/layers/{i}/w`` (in, out) and
``/b``; ``cross/layers/{k}/v`` (r, D), ``/w`` (D, r) and ``/b`` (D,);
``over_arch/layers/{i}/w`` and ``/b``. No dropout. Spans: ``Bags - Lookup``,
``DCN - Component`` with a ``DCN - Layer {k}`` a layer inside. In a training
step the bags' gradient reaches the optimizer as a
:class:`..ops.embedding.BagGrad` and their Adagrad steps the batch's rows
alone (``train.trainer``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..config import ModelConfig
from ..device import DeviceLike, resolve_device, scaled_normal
from ..ops import embedding as emb_ops
from ..ops import interactions as inter_ops
from ..utils import profiling as prof

BAGS = "bags"           # the parameter group that holds the bags' table


def make_bag_spec(cfg: ModelConfig) -> emb_ops.BagSpec:
    return emb_ops.bag_spec(cfg.feature_sizes, cfg.numerical, cfg.bag_sizes)


def cross_width(cfg: ModelConfig) -> int:
    """D, the width of x₀: the dense row and one row a bag."""
    return (1 + cfg.num_categorical) * cfg.embedding_size


def _linears(generator, dims: Sequence[int], dtype, device) -> list:
    """Glorot ``N(0,1)·sqrt(2/(fan_in+fan_out))`` weights (in, out) and
    biases, as ``ops.mlp.init_mlp`` draws a tower's."""
    out = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        glorot = (2.0 / (fi + fo)) ** 0.5
        out.append({"w": scaled_normal(generator, (fi, fo), glorot, dtype, device),
                    "b": scaled_normal(generator, (fo,), glorot, dtype, device)})
    return out


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device: DeviceLike = None, dtype: torch.dtype = torch.float32) -> Dict:
    """The parameter dict: the table N(0, 0.01²), as the port's second-order
    tables; Glorot arches and cross matrices, zero cross biases. Drawn on the
    CPU from ``generator`` and moved; ``device="meta"`` gives a template."""
    if not cfg.use_dlrm:
        raise ValueError("models.dlrm builds DLRM-DCNv2 (use_dlrm) alone")
    device = resolve_device(device)
    spec, e, d, r = make_bag_spec(cfg), cfg.embedding_size, cross_width(cfg), cfg.dcn_low_rank_dim
    glorot = (2.0 / (d + r)) ** 0.5
    return {
        BAGS: {"dense": scaled_normal(generator, (spec.rows, e), 0.01, dtype, device)},
        "dense_arch": {"layers": _linears(generator, (cfg.numerical,) + cfg.dense_arch_layers,
                                          dtype, device)},
        "cross": {"layers": [
            {"v": scaled_normal(generator, (r, d), glorot, dtype, device),
             "w": scaled_normal(generator, (d, r), glorot, dtype, device),
             "b": torch.zeros((d,), dtype=dtype, device=device)}
            for _ in range(cfg.dcn_num_layers)]},
        "over_arch": {"layers": _linears(generator, (d,) + cfg.over_arch_layers, dtype, device)},
    }


def _arch(layers, x: torch.Tensor, last_relu: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = torch.addmm(layer["b"], x, layer["w"])
        if last_relu or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def forward(params: Dict, xi: torch.Tensor, xv: torch.Tensor, cfg: ModelConfig, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            lookup_fn: Optional[Callable] = None) -> torch.Tensor:
    """(xi int (B, Σ bag_sizes), xv f32 (B, numerical)) → logits (B,). The
    model has no dropout: ``train`` and ``generator`` change nothing, and the
    forward is the serving forward too. ``lookup_fn(table, spec, xi)`` pools
    the bags in place of :func:`..ops.embedding.bag_lookup` (a rank's sharded
    lookup, ``parallel/bag_sharding``, which opens its own spans)."""
    b = xi.shape[0]
    dense = _arch(params["dense_arch"]["layers"], xv.to(torch.float32), last_relu=True)
    if lookup_fn is not None:
        bags = lookup_fn(params[BAGS]["dense"], make_bag_spec(cfg), xi)
    else:
        with prof.named_scope(prof.SCOPE_BAGS_LOOKUP):
            bags = emb_ops.bag_lookup(params[BAGS]["dense"], make_bag_spec(cfg), xi)   # (B, C, E)
    x0 = torch.cat([dense[:, None, :], bags], dim=1).reshape(b, -1)
    with prof.named_scope(prof.SCOPE_DCN):
        x = inter_ops.dcn_cross(x0, params["cross"]["layers"])
    return _arch(params["over_arch"]["layers"], x, last_relu=False)[:, 0]


def is_bag_state(path: str) -> bool:
    """Whether a leaf of the step's state (parameters or optimizer slots, by
    path) is a bag table or its accumulator: what a step reads and writes at
    its batch's rows alone."""
    return BAGS in path.split("/")
