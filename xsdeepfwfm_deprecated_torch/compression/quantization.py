"""Post-training int8 quantization: the converted model and its forward.

Port of ``xsdeepfwfm_deprecated_tpu/compression/quantization.py:41-160,
188-333``. ``dynamic`` mode quantizes the deep tower's weights per output
channel and takes activation scales from each batch at run time; ``static``
mode uses calibrated activation scales (``act_scales``). Embedding tables
become weight-only int8 rows with the scale inline. The FM/FwFM
interactions stay float32. :func:`calibrate` records the activation ranges
for static mode. ``mode="qat"`` converts a model trained with
``quantization_aware`` like a dynamic one. The grouped serving layout
(``group_quantized_tables``, a TPU gather workaround with the same logits)
is not ported.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, fields, replace
from typing import Dict, Optional

import numpy as np
import torch

from .. import _tree
from ..config import ModelConfig
from ..device import constant
from ..models import deepfwfm
from ..ops import interactions as inter_ops
from ..ops import quantized as q_ops
from ..ops.cuda.int8_mlp import int8_mlp, pack_quantized_deep
from ..ops.embedding import _clip_per_field, _combine_qr, packed_lookup, packed_lookup_serving
from ..utils import cuda_graph
from ..utils import profiling as prof

FUSED_BLOCK_B = 512   # rows per scale tile of the fused tower


@dataclass
class QuantizedModel:
    """Converted int8 model: fp32 shallow params plus int8 tables and tower."""
    cfg: ModelConfig
    mode: str                       # dynamic | static | qat
    params_fp: Dict                 # bias / lw_w / fwlw_w / field_cov (fp32)
    emb1_q: Optional[Dict]          # weight-only int8 tables {name: {"qs": ...}}
    emb2_q: Optional[Dict]
    deep_q: Optional[Dict]          # {net_i: {layers: [{w_q, w_scale, b}], fc: {w_q, w_scale}}}
    act_scales: Optional[Dict]      # static mode: activation scales
    ffm1_q: Optional[Dict] = None   # FFM int8 tables (DeepFFM family)
    ffm2_q: Optional[Dict] = None

    def _tensor_fields(self):
        return [f.name for f in fields(self) if f.name not in ("cfg", "mode")]

    def size_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for name in self._tensor_fields()
                   for t in _tree.leaves(getattr(self, name)))

    def to(self, device: torch.device) -> "QuantizedModel":
        return replace(self, **{name: _tree.tree_map(lambda t: t.to(device), getattr(self, name))
                                for name in self._tensor_fields()})

    @functools.cached_property
    def fused_tower(self):
        """``net_1`` in the fused kernel's layout, packed on first use."""
        return pack_quantized_deep(self.deep_q)

    @functools.cached_property
    def deep_f(self) -> Dict:
        """The float32 copies of the tower's int8 codes for the layerwise path
        (``ops/quantized.float_codes``), made once on the model's device.
        They are no field: ``size_bytes`` does not count them and a saved
        artifact does not hold them."""
        return {name: {"layers": [q_ops.float_codes(l["w_q"]) for l in net["layers"]],
                       "fc": q_ops.float_codes(net["fc"]["w_q"])}
                for name, net in self.deep_q.items()}


def _quantize_tables(tables: Optional[Dict]) -> Optional[Dict]:
    if tables is None:
        return None
    return {k: q_ops.quantize_embedding_rows(t) for k, t in tables.items()}


def _quantize_deep(deep: Dict) -> Dict:
    out = {}
    for net_name, net in deep.items():
        layers = []
        for layer in net["layers"]:
            w_q, w_scale = q_ops.quantize_symmetric(layer["w"], axis=1)   # per out channel
            layers.append({"w_q": w_q, "w_scale": w_scale.reshape(-1), "b": layer["b"]})
        fc_q, fc_scale = q_ops.quantize_symmetric(net["fc_w"], axis=1)
        out[net_name] = {"layers": layers, "fc": {"w_q": fc_q, "w_scale": fc_scale.reshape(-1)}}
    return out


def convert(params: Dict, cfg: ModelConfig, mode: str = "dynamic",
            act_scales: Optional[Dict] = None,
            quantize_embeddings: bool = True) -> QuantizedModel:
    """fp32 params → :class:`QuantizedModel`, on the params' device. A
    model with ``use_cin`` or ``use_dlrm`` is refused: the int8 forward has
    no CIN, no bags and no cross network."""
    if cfg.use_cin:
        raise ValueError(f"int8 {mode} conversion does not take use_cin: the quantized "
                         "forward has no CIN; serve xDeepFM in fp32")
    if cfg.use_dlrm:
        raise ValueError(f"int8 {mode} conversion does not take use_dlrm: the quantized "
                         "forward has no bags and no cross network; serve DLRM-DCNv2 in fp32")
    params_fp = {k: v for k, v in params.items()
                 if k in ("bias", "lw_w", "fwlw_w", "field_cov")}
    tables = {k: params.get(k) for k in ("emb1", "emb2", "ffm1", "ffm2")}
    if quantize_embeddings:
        q_tables = {k: _quantize_tables(t) for k, t in tables.items()}
    else:
        q_tables = dict.fromkeys(tables)
        params_fp.update({k: t for k, t in tables.items() if t is not None})
    deep_q = _quantize_deep(params["deep"]) if "deep" in params else None
    return QuantizedModel(cfg=cfg, mode=mode, params_fp=params_fp,
                          emb1_q=q_tables["emb1"], emb2_q=q_tables["emb2"], deep_q=deep_q,
                          act_scales=act_scales, ffm1_q=q_tables["ffm1"],
                          ffm2_q=q_tables["ffm2"])


@torch.no_grad()
def calibrate(params: Dict, cfg: ModelConfig, xi: np.ndarray, xv: np.ndarray,
              n_batches: int = 5, batch_size: int = 2048) -> Dict:
    """Static-PTQ calibration: run ``n_batches`` of ``batch_size`` rows and
    record the abs-max of the tower's input and of every hidden layer's
    output, for every deep net (each has its own weights, so its own
    ranges). Runs on the params' device; the scales come back as 0-d tensors
    there, ``{"input": s, "nets": {net: [s, ...]}}``. On the card the
    batches' abs-maxes are one CUDA graph replay each (the JAX package jits
    them, ``:131``), kept on the card until one read after the last."""
    spec = deepfwfm.make_embedding_spec(cfg)
    device = _tree.leaves(params)[0].device
    net_names = [f"net_{i}" for i in range(1, cfg.num_deeps + 1)]

    def layer_maxes(xi_b: torch.Tensor, xv_b: torch.Tensor) -> torch.Tensor:
        b = xi_b.shape[0]
        if cfg.use_ffm:
            f, e = cfg.field_size, cfg.embedding_size
            pair = packed_lookup(params["ffm2"], spec, xi_b, xv_b)
            x0 = pair.reshape(b, f, f, e).sum(dim=2).reshape(b, -1)
        else:
            x0 = packed_lookup(params["emb2"], spec, xi_b, xv_b).reshape(b, -1)
        maxes = [x0.abs().max()]
        for name in net_names:
            x = x0
            for layer in params["deep"][name]["layers"]:
                x = torch.relu(x @ layer["w"] + layer["b"])
                maxes.append(x.abs().max())
        return torch.stack(maxes)

    batch_maxes = cuda_graph.Compiled(layer_maxes, "calibrate", device=device)
    maxes = []
    n = xi.shape[0]
    for i in range(n_batches):
        lo = (i * batch_size) % max(n - batch_size, 1)
        xi_b = torch.from_numpy(np.asarray(xi[lo:lo + batch_size], np.int32)).to(device)
        xv_b = torch.from_numpy(np.asarray(xv[lo:lo + batch_size], np.float32)).to(device)
        maxes.append(batch_maxes((), {"xi_b": xi_b, "xv_b": xv_b}))
    amax = np.zeros(1 + len(net_names) * cfg.h_depth)
    if maxes:       # the one read
        amax = np.maximum(amax, torch.stack(maxes).cpu().numpy().max(axis=0))
    # float64 on the host, rounded once to float32, as the JAX package does
    scales = torch.from_numpy((np.maximum(amax, 1e-12) / 127.0).astype(np.float32)).to(device)
    h = cfg.h_depth
    return {"input": scales[0],
            "nets": {name: list(scales[1 + j * h: 1 + (j + 1) * h].unbind())
                     for j, name in enumerate(net_names)}}


def quantized_lookup_serving(tables_q: Dict, spec, xi: torch.Tensor,
                             xv: torch.Tensor) -> torch.Tensor:
    """Serving lookup on int8 rows: numeric rows are a static slice, the
    categorical fields one gather, each row dequantized with its inline
    scale. Indices clip per field, as in every fp32 lookup."""
    num = spec.numerical
    if not all(n == 1 for n in spec.feature_sizes[:num]):
        raise ValueError("numeric fields must be leading single-row slots")
    dq = tables_q["dense"]
    xi = _clip_per_field(xi, spec.feature_sizes[num:])
    parts = []
    if num:
        rows, sc = q_ops.unpack_qs(dq["qs"][:num])
        parts.append((rows * sc)[None] * xv[..., None])
    cat_offs = constant(spec.dense_offsets[num:], xi.dtype, xi.device)
    emb = q_ops.gather_dequant(dq, (xi + cat_offs).clamp(0, dq["qs"].shape[0] - 1))
    if spec.has_qr:
        c = spec.qr_collisions
        q_offs = constant(spec.q_offsets[num:], xi.dtype, xi.device)
        r_offs = constant(spec.r_offsets[num:], xi.dtype, xi.device)
        eq = q_ops.gather_dequant(tables_q["q"],
                                  (q_offs + xi // c).clamp(0, tables_q["q"]["qs"].shape[0] - 1))
        er = q_ops.gather_dequant(tables_q["r"],
                                  (r_offs + xi % c).clamp(0, tables_q["r"]["qs"].shape[0] - 1))
        mask = constant(spec.is_qr_field[num:], torch.bool, xi.device)[None, :, None]
        emb = torch.where(mask, _combine_qr(spec.qr_operation, eq, er), emb)
    parts.append(emb)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


@functools.lru_cache(maxsize=64)
def _warn_fallback(b: int, static: bool, num_deeps: int) -> None:
    """Logged once per (batch, reason), as the JAX package logs once per
    traced shape. Batches under 512 are the small-batch path by design and
    stay silent."""
    logging.getLogger("xsdeepfwfm_torch").warning(
        "fused int8 tower requested but falling back to the layerwise path: "
        "batch %d %% 512 = %d, act_scales %s, num_deeps %d "
        "(fused needs batch%%512==0, dynamic scales, one net)",
        b, b % FUSED_BLOCK_B, "static" if static else "dynamic", num_deeps)


def quantized_forward(qm: QuantizedModel, xi: torch.Tensor, xv: torch.Tensor,
                      use_fused_kernel: bool = False) -> torch.Tensor:
    """Serving forward on the int8 path, the eval-mode forward with int8
    embedding rows and an int8 deep tower. ``use_fused_kernel`` runs the tower
    as the fused kernel (per-tile scales) when the scales are dynamic, there
    is one net and the batch is a multiple of 512; otherwise the tower runs
    layer by layer (per-batch scales). The components are spans under the
    JAX forward's names (:mod:`..utils.profiling`)."""
    cfg = qm.cfg
    spec = deepfwfm.make_embedding_spec(cfg)
    b = xi.shape[0]

    def lookup(tables_q, tables_fp):
        if tables_q is None:
            return packed_lookup_serving(tables_fp, spec, xi, xv)
        return quantized_lookup_serving(tables_q, spec, xi, xv)

    first_order = second_order = emb2 = pair_emb = x_deep = None
    if cfg.use_logit or cfg.use_fm or cfg.use_fwfm:
        if not cfg.use_fwlw:
            with prof.named_scope(prof.SCOPE_FM):
                first_order = lookup(qm.emb1_q, qm.params_fp.get("emb1"))[..., 0]
        if cfg.use_fm or cfg.use_fwfm:
            with prof.named_scope(prof.SCOPE_FM):
                emb2 = lookup(qm.emb2_q, qm.params_fp.get("emb2"))
            if cfg.use_fwlw:
                with prof.named_scope(prof.SCOPE_FWLW):
                    first_order = inter_ops.fwfm_linear_term(emb2, qm.params_fp["fwlw_w"])
            if cfg.use_fm:
                with prof.named_scope(prof.SCOPE_OUTER_FM):
                    second_order = inter_ops.fm_second_order(emb2)
            else:
                with prof.named_scope(prof.SCOPE_OUTER_FWFM):
                    second_order = inter_ops.fwfm_second_order(emb2, qm.params_fp["field_cov"])

    if cfg.use_ffm:
        f, e = cfg.field_size, cfg.embedding_size
        first_order = lookup(qm.ffm1_q, qm.params_fp.get("ffm1"))[..., 0]
        pair_emb = lookup(qm.ffm2_q, qm.params_fp.get("ffm2")).reshape(b, f, f, e)
        second_order = inter_ops.ffm_second_order(pair_emb)

    if cfg.use_deep:
        if cfg.use_ffm:
            x = pair_emb.sum(dim=2).reshape(b, -1)
        else:
            if emb2 is None:
                emb2 = lookup(qm.emb2_q, qm.params_fp.get("emb2"))
            x = emb2.reshape(b, -1).contiguous()
        with prof.named_scope(prof.SCOPE_DEEP):
            act = qm.act_scales
            fused_ok = (use_fused_kernel and act is None and cfg.num_deeps == 1
                        and b % FUSED_BLOCK_B == 0)
            if use_fused_kernel and not fused_ok and b >= FUSED_BLOCK_B:
                _warn_fallback(b, act is not None, cfg.num_deeps)
            if fused_ok:
                layers_q, fc_q = qm.fused_tower
                x_deep = int8_mlp(x, layers_q, fc_q, block_b=FUSED_BLOCK_B)
            for nidx in (() if fused_ok else range(1, cfg.num_deeps + 1)):
                net, net_f = qm.deep_q[f"net_{nidx}"], qm.deep_f[f"net_{nidx}"]
                # per-net calibrated scales; "hidden" is the single-net artifact layout
                a_hidden = (act["nets"][f"net_{nidx}"] if act is not None and "nets" in act
                            else act["hidden"] if act is not None else None)
                h = x
                for i, layer in enumerate(net["layers"]):
                    a_scale = None if act is None else (a_hidden[i - 1] if i > 0 else act["input"])
                    h = torch.relu(q_ops.quantized_dense(h, layer["w_q"], layer["w_scale"],
                                                         layer["b"], a_scale,
                                                         w_f=net_f["layers"][i]))
                x_deep = q_ops.quantized_dense(h, net["fc"]["w_q"], net["fc"]["w_scale"], None,
                                               None if act is None else a_hidden[-1],
                                               w_f=net_f["fc"])

    return deepfwfm._assemble(cfg, qm.params_fp, first_order, second_order, x_deep)
