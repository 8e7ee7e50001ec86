"""Unified FM-family model as plain functions on a dict of tensors.

Port of ``xsdeepfwfm_deprecated_tpu/models/deepfwfm.py:39-231``: LR / FM /
FFM / FwFM / DeepFM / DeepFFM / DeepFwFM / deep-only, with ``use_lw`` /
``use_fwlw`` linear terms and QR embeddings. The parameter dict has the JAX
layout and leaf names (``emb2/dense``, ``deep/net_1/layers/0/w`` as
``(in, out)``, ``deep/net_1/fc_w``, ``field_cov``, ``fwlw_w``, ``lw_w``,
``bias``). With ``num_deeps > 1`` every net runs and only the last counts.
``use_cin`` adds xDeepFM (the port's own; the JAX package has none): a
``cin`` subtree of ``layers/{k-1}/w`` (H_k, H_{k-1}·F) for CIN layer k and
``fc_w`` (ΣH_k, 1), run on the second-order lookup that the tower reads too.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch

from .. import _tree
from ..config import ModelConfig
from ..device import DeviceLike, resolve_device, scaled_normal
from ..ops import embedding as emb_ops
from ..ops import interactions as inter_ops
from ..ops import mlp as mlp_ops
from ..ops.embedding import PackedEmbeddingSpec
from ..ops.quantized import AmaxFn
from ..utils import profiling as prof


def make_embedding_spec(cfg: ModelConfig) -> PackedEmbeddingSpec:
    return emb_ops.make_spec(
        cfg.feature_sizes, cfg.numerical, qr_flag=cfg.qr_flag,
        qr_collisions=cfg.qr_collisions, qr_threshold=cfg.qr_threshold,
        qr_operation=cfg.qr_operation)


def _head_scale(cfg: ModelConfig) -> float:
    """sqrt(2/last_layer_size) for the lw / fc heads."""
    last = 0
    if cfg.use_fm or cfg.use_fwfm:
        last += cfg.field_size + cfg.embedding_size
    if cfg.use_deep:
        last += cfg.deep_layers[-1] + 1
    return (2.0 / last) ** 0.5 if last > 0 else 1.0


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device: DeviceLike = None, dtype: torch.dtype = torch.float32) -> Dict:
    """Parameter dict with the JAX package's init distributions. Values are
    drawn on the CPU from ``generator`` and then moved, so one seed gives the
    same parameters on every device. ``device="meta"`` gives a template of
    shapes and dtypes (no generator needed)."""
    if cfg.use_dlrm:
        raise ValueError("DLRM-DCNv2 (use_dlrm) is models.dlrm's, trained by "
                         "train.trainer.DLRMEstimator (models.factory.get_model picks it)")
    device = resolve_device(device)
    spec = make_embedding_spec(cfg)
    f, e = cfg.field_size, cfg.embedding_size
    head = _head_scale(cfg)
    tdt = torch.bfloat16 if cfg.table_dtype == "bf16" else dtype
    params: Dict = {}

    if cfg.use_shallow or cfg.use_cin:
        params["bias"] = torch.tensor([0.01], dtype=dtype, device=device)
    if cfg.needs_emb1:
        params["emb1"] = emb_ops.init_tables(generator, spec, 1, 1.0, tdt, device)
    if cfg.needs_emb2:
        params["emb2"] = emb_ops.init_tables(generator, spec, e, 0.01, tdt, device)
    if (cfg.use_fm or cfg.use_fwfm) and cfg.use_lw:
        params["lw_w"] = scaled_normal(generator, (f, 1), head, dtype, device)
    if (cfg.use_fm or cfg.use_fwfm or cfg.use_ffm) and cfg.use_fwlw:
        params["fwlw_w"] = scaled_normal(generator, (f, e), (2.0 / (f + e)) ** 0.5,
                                         dtype, device)
    if cfg.use_fwfm:
        params["field_cov"] = scaled_normal(generator, (f, f), (2.0 / f / 2.0) ** 0.5,
                                            dtype, device)
    if cfg.use_ffm:
        params["ffm1"] = emb_ops.init_tables(generator, spec, 1, 1.0, tdt, device)
        params["ffm2"] = emb_ops.init_tables(generator, spec, f * e, 0.01, tdt, device)
    if cfg.use_deep:
        params["deep"] = {
            f"net_{n}": mlp_ops.init_mlp(generator, f * e, cfg.deep_layers, head, dtype, device)
            for n in range(1, cfg.num_deeps + 1)}
    if cfg.use_cin:
        params["cin"] = init_cin(generator, f, cfg.cin_layers, dtype, device)
    return params


def init_cin(generator: Optional[torch.Generator], fields: int, layers, dtype: torch.dtype,
             device: torch.device) -> Dict:
    """The CIN's leaves, Glorot-scaled ``N(0,1)·sqrt(2/(fan_in+fan_out))``:
    each layer's (H_k, H_{k-1}·F) matrix, H_0 = F, and the (ΣH_k, 1) head."""
    dims = (fields,) + tuple(layers)
    ws = [scaled_normal(generator, (h, hp * fields), (2.0 / (hp * fields + h)) ** 0.5,
                        dtype, device) for hp, h in zip(dims[:-1], dims[1:])]
    total = sum(layers)
    return {"layers": [{"w": w} for w in ws],
            "fc_w": scaled_normal(generator, (total, 1), (2.0 / (total + 1)) ** 0.5,
                                  dtype, device)}


LookupFn = Callable[[Dict, PackedEmbeddingSpec, torch.Tensor, torch.Tensor], torch.Tensor]


def forward(params: Dict, xi: torch.Tensor, xv: torch.Tensor, cfg: ModelConfig, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            lookup_fn: Optional[LookupFn] = None,
            amax_fn: Optional[AmaxFn] = None) -> torch.Tensor:
    """(xi int (B, C), xv f32 (B, Nnum)) → logits (B,). ``lookup_fn``
    replaces the packed-table gather (the serving form, for example);
    ``amax_fn`` takes the QAT tower's activation abs-max over the whole batch
    when these are one rank's rows of it (``ops.mlp.qat_mlp_forward``). The
    components are spans under the JAX forward's names (:mod:`..utils.profiling`)."""
    spec = make_embedding_spec(cfg)
    lookup = lookup_fn or emb_ops.packed_lookup
    b = xi.shape[0]
    shallow_drop = train and cfg.is_shallow_dropout

    first_order = second_order = emb2 = pair_emb = x_deep = cin = None
    if cfg.use_cin:     # xDeepFM: the linear part, then the CIN on the shared lookup
        first_order = mlp_ops.dropout(generator, lookup(params["emb1"], spec, xi, xv)[..., 0],
                                      cfg.dropout_shallow[0], shallow_drop)
        emb2 = lookup(params["emb2"], spec, xi, xv)                             # (B, F, E)
        with prof.named_scope(prof.SCOPE_CIN):
            cin = inter_ops.cin_forward(emb2, [layer["w"] for layer in params["cin"]["layers"]])

    if cfg.use_logit or cfg.use_fm or cfg.use_fwfm:
        if not cfg.use_fwlw:
            with prof.named_scope(prof.SCOPE_FM):
                first_order = lookup(params["emb1"], spec, xi, xv)[..., 0]      # (B, F)
            first_order = mlp_ops.dropout(generator, first_order,
                                          cfg.dropout_shallow[0], shallow_drop)
        if cfg.use_fm or cfg.use_fwfm:
            with prof.named_scope(prof.SCOPE_FM):
                emb2 = lookup(params["emb2"], spec, xi, xv)                     # (B, F, E)
            if cfg.use_fwlw:
                with prof.named_scope(prof.SCOPE_FWLW):
                    first_order = inter_ops.fwfm_linear_term(emb2, params["fwlw_w"])
                first_order = mlp_ops.dropout(generator, first_order,
                                              cfg.dropout_shallow[0], shallow_drop)
            if cfg.use_fm:
                with prof.named_scope(prof.SCOPE_OUTER_FM):
                    second_order = inter_ops.fm_second_order(emb2)
            else:
                with prof.named_scope(prof.SCOPE_OUTER_FWFM):
                    second_order = inter_ops.fwfm_second_order(emb2, params["field_cov"])
            second_order = mlp_ops.dropout(generator, second_order,
                                           cfg.dropout_shallow[1], shallow_drop)

    if cfg.use_ffm:
        f, e = cfg.field_size, cfg.embedding_size
        first_order = lookup(params["ffm1"], spec, xi, xv)[..., 0]
        first_order = mlp_ops.dropout(generator, first_order,
                                      cfg.dropout_shallow[0], shallow_drop)
        pair_emb = lookup(params["ffm2"], spec, xi, xv).reshape(b, f, f, e)
        second_order = mlp_ops.dropout(generator, inter_ops.ffm_second_order(pair_emb),
                                       cfg.dropout_shallow[1], shallow_drop)

    if cfg.use_deep:
        if cfg.use_ffm:
            deep_in = pair_emb.sum(dim=2)                    # Σ_j e_{i,j}
        else:
            deep_in = emb2 if emb2 is not None else lookup(params["emb2"], spec, xi, xv)
        rates = ((cfg.dropout_deep,) if cfg.is_deep_dropout else (0.0,)) * (cfg.h_depth + 1)
        deep_fn = mlp_ops.mlp_forward
        if cfg.quantization_aware:      # the QAT tower quantizes the flat activation vector
            deep_in = deep_in.reshape(b, -1)
            deep_fn = partial(mlp_ops.qat_mlp_forward, amax_fn=amax_fn)
        with prof.named_scope(prof.SCOPE_DEEP):
            for n in range(1, cfg.num_deeps + 1):
                x_deep = deep_fn(params["deep"][f"net_{n}"], deep_in, dropout_rates=rates,
                                 train=train, generator=generator)

    return _assemble(cfg, params, first_order, second_order, x_deep, cin)


def _assemble(cfg: ModelConfig, params_fp: Dict, first_order, second_order,
              x_deep, cin=None) -> torch.Tensor:
    """Sum the logit's terms; shared by the fp32 and the int8 forward. ``cin``
    is the CIN's p⁺ (B, ΣH_k), which the head ``cin/fc_w`` weighs."""
    if (cfg.use_fm or cfg.use_fwfm) and cfg.use_lw:
        first_order = first_order @ params_fp["lw_w"]                           # (B, 1)
    bias = params_fp["bias"][0] if "bias" in params_fp else 0.01
    if cfg.use_logit:
        return first_order.sum(dim=1) + bias
    total = 0.0
    if cfg.use_fm or cfg.use_fwfm or cfg.use_ffm:
        total = first_order.sum(dim=1) + second_order.sum(dim=1)
    if cfg.use_cin:
        total = first_order.sum(dim=1) + (cin @ params_fp["cin"]["fc_w"])[:, 0]
    if cfg.use_deep:
        total = total + x_deep.sum(dim=1)
    return total + bias


def param_count(params: Dict) -> int:
    return int(sum(p.numel() for p in _tree.leaves(params)))


def nonzero_param_count(params: Dict) -> int:
    return sum(_nonzero_counts(_tree.leaves(params)))


def _nonzero_counts(tensors) -> list:
    """Non-zero count of each tensor, fetched from the device in one copy."""
    return torch.stack([torch.count_nonzero(t) for t in tensors]).tolist()


def param_group_counts(params: Dict, cfg: ModelConfig, nonzero: bool = False) -> Dict[str, int]:
    """Parameters (or non-zero parameters) per group, as the reference's
    summaries count them: first- and second-order embeddings, the DNN's
    hidden layers, the non-zeros of the symmetrized field matrix, the total."""
    named = list(_tree.named_leaves(params))
    counts = (_nonzero_counts([p for _, p in named]) if nonzero
              else [p.numel() for _, p in named])
    groups = {"first_order_embeddings": 0, "second_order_embeddings": 0, "dnn": 0,
              "field_cov_nonzero_sym": 0, "total": 0}
    for (name, _), c in zip(named, counts):
        groups["total"] += c
        if name.startswith(("emb1", "ffm1")):
            groups["first_order_embeddings"] += c
        if name.startswith(("emb2", "ffm2")):
            groups["second_order_embeddings"] += c
        if name.startswith("deep") and ("/w" in name or "/b" in name) and "fc_w" not in name:
            groups["dnn"] += c
    if "field_cov" in params:
        r = params["field_cov"]
        groups["field_cov_nonzero_sym"] = int(torch.count_nonzero(0.5 * (r + r.T)))
    return groups
