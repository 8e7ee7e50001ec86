"""Serve-time compaction of pruned models.

Port of ``xsdeepfwfm_deprecated_tpu/serving/compaction.py``. Scattered zeros
buy nothing on dense matrix hardware, so DeepLight pruning pays at serving
time through STRUCTURAL compaction, done once offline on the host:

1. **Embedding row compaction.** Rows of the packed table that pruning
   zeroed entirely are dropped. One int32 remap array sends every original
   row id to its surviving compact row or to a shared all-zero row 0. A
   lookup becomes remap-gather → row-gather and gives what gathering the
   zero row gave.
2. **Deep-tower unit compaction.** A hidden unit whose incoming weights are
   all zero computes ``relu(b_j)``, a constant: that constant is folded into
   the next layer's bias (or the new fc bias) and the unit is dropped, with
   its weight column, its bias and the next layer's row. Dead input
   dimensions of layer 0 go through a static column gather. The result is a
   smaller DENSE tower with the same logits. Unstructured pruning leaves
   almost no dead units; the structured mode
   (``compression.pruning.prune_params(structured_deep=True)``, CLI
   ``-prune_deep_structured``) prunes whole units on the same schedule.
3. **Optional int8.** Compact tables get per-row int8 scales (dequantized on
   the gather) and compact tower layers per-channel int8 products, layer by
   layer with a per-batch activation scale. The fused int8 tower kernel is
   not used here: its scale is per tile of 512 rows, which gives other logits.

The folding runs in numpy float32 on the host, as in the JAX package, so the
compact arrays of the two packages are equal to the bit.

The compact lookup clips an index to the TABLE (the remap's length), not to
its field, unlike every other lookup of the port: it serves what the JAX
``Predictor`` serves for a ``CompactModel``.

:func:`compact_for_serving` builds a :class:`CompactModel`;
:func:`compact_forward` is its eval forward, logit-equal to
``deepfwfm.forward`` on the pruned params.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _tree
from ..config import ModelConfig
from ..device import constant
from ..models import deepfwfm
from ..ops import interactions as inter_ops
from ..ops import quantized as q_ops
from ..ops.embedding import _combine_qr, _take

_TREES = ("params_fp", "emb1", "emb2", "deep")


@dataclass
class CompactModel:
    """Pruned model compacted for serving."""

    cfg: ModelConfig
    int8: bool
    keep_in0: Tuple[int, ...]           # static layer-0 input dims kept
    params_fp: Dict                     # bias / lw_w / fwlw_w / field_cov
    emb1: Optional[Dict]                # {remap, dense | dense_q, q, r | q_q, r_q}
    emb2: Optional[Dict]
    deep: Optional[Dict]                # {layers: [{w|w_q.., b}], fc_w|fc.., fc_b}

    def size_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for name in _TREES for t in _tree.leaves(getattr(self, name)))

    def to(self, device: torch.device) -> "CompactModel":
        return replace(self, **{name: _tree.tree_map(lambda t: t.to(device), getattr(self, name))
                                for name in _TREES})

    @functools.cached_property
    def deep_f(self) -> Optional[Dict]:
        """The float32 copies of the int8 tower's codes
        (``ops/quantized.float_codes``), made once on the model's device.
        They are no field, so ``size_bytes`` does not count them."""
        if not self.int8 or self.deep is None:
            return None
        return {"layers": [q_ops.float_codes(l["w_q"]) for l in self.deep["layers"]],
                "fc": q_ops.float_codes(self.deep["fc"]["w_q"])}

    @functools.cached_property
    def numeric_rows(self) -> Dict[str, Optional[torch.Tensor]]:
        """Per table set, the compact rows of the numeric fields: their static
        offsets sent through the remap once, not on every request."""
        spec = deepfwfm.make_embedding_spec(self.cfg)
        out = {}
        for name in ("emb1", "emb2"):
            tables = getattr(self, name)
            if tables is None or not spec.numerical:
                out[name] = None
                continue
            ref = _tree.leaves(tables)[0]
            nidx = torch.tensor(spec.dense_offsets[:spec.numerical], dtype=torch.int32,
                                device=ref.device)
            remap = tables.get("remap")
            out[name] = nidx if remap is None else remap.index_select(0, nidx)
        return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """On the host as numpy; a bf16 table widened to float32, which numpy has."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _compact_tables(tables: Dict, int8: bool, compact_rows: bool = True) -> Dict:
    """Drop all-zero rows of the packed dense table behind an int32 remap.

    Compact row 0 is an explicit zero row every pruned original row maps to,
    so the two-step gather reproduces the original lookup exactly. QR q/r
    tables are small and kept whole (int8-quantized when asked).

    ``compact_rows=False`` keeps the table full-size with NO remap (the
    lookup stays a single gather): row compaction trades a second gather per
    lookup for memory."""
    dense = _numpy(tables["dense"])
    if compact_rows:
        alive = np.any(dense != 0, axis=1)
        remap = np.zeros(dense.shape[0], np.int32)
        remap[alive] = 1 + np.arange(int(alive.sum()), dtype=np.int32)
        compact = np.concatenate(
            [np.zeros((1, dense.shape[1]), dense.dtype), dense[alive]], axis=0)
        out = {"remap": torch.from_numpy(remap)}
    else:
        compact = dense
        out = {}
    compact_t = torch.from_numpy(np.ascontiguousarray(compact))
    if int8:
        out["dense_q"] = q_ops.quantize_embedding_rows(compact_t)
    else:
        out["dense"] = compact_t
    for k in ("q", "r"):
        if k in tables:
            t = tables[k].detach().cpu()
            out[k + "_q" if int8 else k] = q_ops.quantize_embedding_rows(t) if int8 else t
    return out


def _compact_tower(net: Dict) -> Tuple[List[Dict], torch.Tensor, torch.Tensor, np.ndarray]:
    """Exact unit compaction of one deep net (layers + fc head).

    Returns (compact layers, fc_w, fc_b, kept layer-0 input dims). A unit j
    with an all-zero weight column outputs the constant ``relu(b_j)``; its
    contribution ``relu(b_j)·W_next[j]`` folds into the next bias (or fc_b),
    then column j, b_j and row j of W_next are dropped."""
    ws = [_numpy(l["w"]) for l in net["layers"]]        # (in, out) each
    bs = [_numpy(l["b"]).copy() for l in net["layers"]]
    fc_w = _numpy(net["fc_w"]).copy()                   # (out_L, 1)
    fc_b = np.zeros((1,), fc_w.dtype)

    # dead layer-0 input dims (all-zero weight ROWS): gather them away
    keep_in = np.flatnonzero(np.any(ws[0] != 0, axis=1))
    if keep_in.size == 0:
        keep_in = np.asarray([0])
    ws[0] = ws[0][keep_in]

    for l in range(len(ws)):
        dead = ~np.any(ws[l] != 0, axis=0)              # units with zero column
        if not dead.any():
            continue
        const = np.maximum(bs[l][dead], 0.0)            # relu(b_j) constants
        if l + 1 < len(ws):
            bs[l + 1] = bs[l + 1] + const @ ws[l + 1][dead]
            ws[l + 1] = np.ascontiguousarray(ws[l + 1][~dead])
        else:
            fc_b = fc_b + const @ fc_w[dead]
            fc_w = np.ascontiguousarray(fc_w[~dead])
        ws[l] = np.ascontiguousarray(ws[l][:, ~dead])
        bs[l] = np.ascontiguousarray(bs[l][~dead])

    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    layers = [{"w": as_t(w), "b": as_t(b)} for w, b in zip(ws, bs)]
    return layers, as_t(fc_w), as_t(fc_b), keep_in


def compact_for_serving(params: Dict, cfg: ModelConfig, int8: bool = False,
                        compact_rows: bool = True) -> CompactModel:
    """Pruned fp32 params → :class:`CompactModel` (optionally int8), built on
    the host; ``CompactModel.to`` or the ``Predictor`` moves it to a device.

    ``compact_rows=False`` keeps embedding tables full-size (no remap
    indirection): the tower still compacts, the lookup stays one gather."""
    if cfg.use_cin:
        raise ValueError("compaction does not take use_cin: the compact forward has no CIN")
    if cfg.use_dlrm:
        raise ValueError("compaction does not take use_dlrm: the compact forward has no bags "
                         "and no cross network")
    if cfg.use_ffm:
        raise NotImplementedError(
            "compaction covers the DeepLight families (LR/FM/FwFM/DeepFwFM); "
            "FFM's (Σn_i, F·E) tables are memory-prohibitive at the scales "
            "where compaction matters")
    params_fp = {k: v.detach().cpu() for k, v in params.items()
                 if k in ("bias", "lw_w", "fwlw_w", "field_cov")}
    emb1 = _compact_tables(params["emb1"], int8, compact_rows) if "emb1" in params else None
    emb2 = _compact_tables(params["emb2"], int8, compact_rows) if "emb2" in params else None

    deep = None
    keep_in0: Tuple[int, ...] = ()
    if "deep" in params:
        # reference semantics: only the LAST net contributes (DeepFMs.py:430-433)
        net = params["deep"][f"net_{cfg.num_deeps}"]
        layers, fc_w, fc_b, keep_in = _compact_tower(net)
        keep_in0 = tuple(int(i) for i in keep_in)
        if int8:
            q_layers = []
            for l in layers:
                w_q, w_s = q_ops.quantize_symmetric(l["w"], axis=1)
                q_layers.append({"w_q": w_q, "w_scale": w_s.reshape(-1), "b": l["b"]})
            fc_q, fc_s = q_ops.quantize_symmetric(fc_w, axis=1)
            deep = {"layers": q_layers,
                    "fc": {"w_q": fc_q, "w_scale": fc_s.reshape(-1)}, "fc_b": fc_b}
        else:
            deep = {"layers": layers, "fc_w": fc_w, "fc_b": fc_b}

    return CompactModel(cfg=cfg, int8=int8, keep_in0=keep_in0,
                        params_fp=params_fp, emb1=emb1, emb2=emb2, deep=deep)


def _rows(tables: Dict, key: str, idx: torch.Tensor, int8: bool) -> torch.Tensor:
    """Gather rows of the table ``key`` (its int8 form dequantized)."""
    if int8:
        return q_ops.gather_dequant(tables[key + "_q"], idx)
    return _take(tables[key], idx)


def _lookup(tables: Dict, spec, xi: torch.Tensor, xv: torch.Tensor,
            int8: bool, numeric_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serving-form compacted lookup: the numeric rows (``numeric_rows``, the
    static offsets already remapped; worked out here when not given), then
    ONE categorical remap-gather → ONE row-gather (→ dequantize) → QR merge.
    Indices clip to the table, as the JAX package's compact lookup does."""
    num = spec.numerical
    assert all(n == 1 for n in spec.feature_sizes[:num])
    remap = tables.get("remap")   # None = rows kept full-size, direct gather
    n_rows = (tables["dense_q"]["qs"] if int8 else tables["dense"]).shape[0]
    parts = []
    if num:
        nidx = numeric_rows
        if nidx is None:
            nidx = constant(tuple(spec.dense_offsets[:num]), torch.int32, xi.device)
            if remap is not None:
                nidx = remap.index_select(0, nidx)
        parts.append(xv[..., None] * _rows(tables, "dense", nidx, int8)[None])
    cat_offs = constant(tuple(spec.dense_offsets[num:]), xi.dtype, xi.device)
    if remap is not None:
        gidx = _take(remap[:, None], (xi + cat_offs).clamp(0, remap.shape[0] - 1))[..., 0]
    else:
        gidx = (xi + cat_offs).clamp(0, n_rows - 1)
    emb = _rows(tables, "dense", gidx, int8)
    if spec.has_qr:
        c = spec.qr_collisions
        q_rows = (tables["q_q"]["qs"] if int8 else tables["q"]).shape[0]
        r_rows = (tables["r_q"]["qs"] if int8 else tables["r"]).shape[0]
        qi = (constant(tuple(spec.q_offsets[num:]), xi.dtype, xi.device) + xi // c
              ).clamp(0, q_rows - 1)
        ri = (constant(tuple(spec.r_offsets[num:]), xi.dtype, xi.device) + xi % c
              ).clamp(0, r_rows - 1)
        qr = _combine_qr(spec.qr_operation, _rows(tables, "q", qi, int8),
                         _rows(tables, "r", ri, int8))
        mask = constant(tuple(spec.is_qr_field[num:]), torch.bool, xi.device)[None, :, None]
        emb = torch.where(mask, qr, emb)
    parts.append(emb)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def compact_forward(cm: CompactModel, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Eval forward over a CompactModel; logit-equal to
    :func:`..models.deepfwfm.forward` on the pruned params."""
    cfg = cm.cfg
    spec = deepfwfm.make_embedding_spec(cfg)
    b = xi.shape[0]

    first_order = second_order = emb2 = x_deep = None
    if cfg.use_logit or cfg.use_fm or cfg.use_fwfm:
        if not cfg.use_fwlw:
            first_order = _lookup(cm.emb1, spec, xi, xv, cm.int8,
                                  cm.numeric_rows["emb1"])[..., 0]
        if cfg.use_fm or cfg.use_fwfm:
            emb2 = _lookup(cm.emb2, spec, xi, xv, cm.int8, cm.numeric_rows["emb2"])
            if cfg.use_fwlw:
                first_order = inter_ops.fwfm_linear_term(emb2, cm.params_fp["fwlw_w"])
            second_order = (inter_ops.fm_second_order(emb2) if cfg.use_fm
                            else inter_ops.fwfm_second_order(emb2, cm.params_fp["field_cov"]))

    if cfg.use_deep:
        if emb2 is None:
            emb2 = _lookup(cm.emb2, spec, xi, xv, cm.int8, cm.numeric_rows["emb2"])
        h = emb2.reshape(b, -1)
        if len(cm.keep_in0) < h.shape[1]:
            h = h.index_select(1, constant(cm.keep_in0, torch.long, h.device))
        if cm.int8:
            deep_f = cm.deep_f
            for layer, w_f in zip(cm.deep["layers"], deep_f["layers"]):
                h = torch.relu(q_ops.quantized_dense(h, layer["w_q"], layer["w_scale"],
                                                     layer["b"], w_f=w_f))
            x_deep = q_ops.quantized_dense(h, cm.deep["fc"]["w_q"], cm.deep["fc"]["w_scale"],
                                           None, w_f=deep_f["fc"]) + cm.deep["fc_b"]
        else:
            for layer in cm.deep["layers"]:
                h = torch.relu(h @ layer["w"] + layer["b"])
            x_deep = h @ cm.deep["fc_w"] + cm.deep["fc_b"]

    return deepfwfm._assemble(cfg, cm.params_fp, first_order, second_order, x_deep)


def compaction_report(params: Dict, cm: CompactModel, cfg: ModelConfig) -> Dict:
    """What compaction bought: row/unit survival and byte footprints."""
    out: Dict[str, float] = {"int8": cm.int8}
    if "emb2" in params and cm.emb2 is not None:
        rows = params["emb2"]["dense"].shape[0]
        table = cm.emb2["dense_q"]["qs"] if cm.int8 else cm.emb2["dense"]
        kept = table.shape[0] - ("remap" in cm.emb2)
        out["emb2_rows"] = rows
        out["emb2_rows_kept"] = kept
        out["emb2_zero_row_pct"] = 100.0 * (1 - kept / max(rows, 1))
    if "deep" in params and cm.deep is not None:
        net = params["deep"][f"net_{cfg.num_deeps}"]
        orig = [tuple(l["w"].shape) for l in net["layers"]]
        comp = [tuple(l.get("w", l.get("w_q")).shape) for l in cm.deep["layers"]]
        out["tower_shapes_orig"] = orig
        out["tower_shapes_compact"] = comp
        orig_macs = sum(int(np.prod(s)) for s in orig)
        comp_macs = sum(int(np.prod(s)) for s in comp)
        out["tower_mac_reduction"] = orig_macs / max(comp_macs, 1)
    out["bytes_full"] = sum(t.numel() * t.element_size() for t in _tree.leaves(params))
    out["bytes_compact"] = cm.size_bytes()
    return out
