"""Packed embedding tables: one gather over all fields.

Port of ``xsdeepfwfm_deprecated_tpu/ops/embedding.py``. All per-field tables
are packed into one ``(sum(feature_sizes), E)`` table with static per-field
row offsets, so a lookup is one gather of shape ``(B, F)`` → ``(B, F, E)``.
A numeric field has one row, scaled by the raw value. QR (quotient-remainder)
fields read packed quotient and remainder tables instead of the dense one.

The training lookup has its own backward (:class:`_FieldGather`); the
serving lookup is forward-only.

Not ported, because they are TPU gather workarounds that leave the result
unchanged: the routed and windowed gathers (``:161-339``) and the grouped
serving layout (``:487-560``). Every lookup here is one flat ``index_select``.
Out-of-range indices resolve to their field's last row, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from ..device import constant, scaled_normal


@dataclass(frozen=True)
class PackedEmbeddingSpec:
    """Static layout of a packed (possibly QR-composed) embedding table set."""

    feature_sizes: Tuple[int, ...]
    numerical: int
    qr_flag: bool = False
    qr_collisions: int = 4
    qr_threshold: int = 200
    qr_operation: str = "mult"

    # Derived (filled by make_spec)
    dense_offsets: Tuple[int, ...] = ()
    dense_rows: int = 0
    q_offsets: Tuple[int, ...] = ()
    q_rows: int = 0
    r_offsets: Tuple[int, ...] = ()
    r_rows: int = 0
    is_qr_field: Tuple[bool, ...] = ()

    @property
    def field_size(self) -> int:
        return len(self.feature_sizes)

    @property
    def has_qr(self) -> bool:
        return any(self.is_qr_field)

    @property
    def total_rows(self) -> int:
        return self.dense_rows + self.q_rows + self.r_rows


def make_spec(feature_sizes: Sequence[int], numerical: int, *, qr_flag: bool = False,
              qr_collisions: int = 4, qr_threshold: int = 200,
              qr_operation: str = "mult") -> PackedEmbeddingSpec:
    """Compute packed offsets. A field uses QR iff ``qr_flag`` and its
    cardinality exceeds ``qr_threshold``."""
    dense_offsets, q_offsets, r_offsets, is_qr = [], [], [], []
    d_off = q_off = r_off = 0
    for n in feature_sizes:
        use_qr = bool(qr_flag and n > qr_threshold)
        is_qr.append(use_qr)
        if use_qr:
            dense_offsets.append(0)       # unused for this field
            q_offsets.append(q_off)
            r_offsets.append(r_off)
            q_off += -(-n // qr_collisions)   # ceil(n / collisions)
            r_off += qr_collisions
        else:
            dense_offsets.append(d_off)
            q_offsets.append(0)
            r_offsets.append(0)
            d_off += n
    return PackedEmbeddingSpec(
        feature_sizes=tuple(int(n) for n in feature_sizes), numerical=numerical,
        qr_flag=qr_flag, qr_collisions=qr_collisions, qr_threshold=qr_threshold,
        qr_operation=qr_operation,
        dense_offsets=tuple(dense_offsets), dense_rows=d_off,
        q_offsets=tuple(q_offsets), q_rows=q_off,
        r_offsets=tuple(r_offsets), r_rows=r_off,
        is_qr_field=tuple(is_qr))


def init_tables(generator: torch.Generator, spec: PackedEmbeddingSpec, embedding_dim: int,
                scale: float = 1.0, dtype: torch.dtype = torch.float32,
                device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """N(0,1)·scale init for every table (dense, and q/r when QR is on)."""
    tables = {"dense": scaled_normal(generator, (max(spec.dense_rows, 1), embedding_dim),
                                     scale, dtype, device)}
    if spec.has_qr:
        qd, rd = _qr_dims(spec, embedding_dim)
        tables["q"] = scaled_normal(generator, (spec.q_rows, qd), scale, dtype, device)
        tables["r"] = scaled_normal(generator, (spec.r_rows, rd), scale, dtype, device)
    return tables


def _qr_dims(spec: PackedEmbeddingSpec, embedding_dim: int) -> Tuple[int, int]:
    """Per-table dims for the QR combine: mult/add keep E per table; concat
    splits E between the two tables so the output stays E."""
    if spec.qr_operation == "concat":
        return embedding_dim // 2, embedding_dim - embedding_dim // 2
    return embedding_dim, embedding_dim


def build_indices(spec: PackedEmbeddingSpec, xi: torch.Tensor, xv: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xi int (B, C), xv f32 (B, Nnum)) → (raw per-field index (B, F), scale (B, F)).

    Numeric fields use index 0 into their single-row slot with scale = value;
    categorical fields use the mapped index with scale = 1.
    """
    b, num = xi.shape[0], spec.numerical
    raw = torch.cat([xi.new_zeros((b, num)), xi], dim=1)
    scale = torch.cat([xv, xv.new_ones((b, spec.field_size - num))], dim=1)
    return raw, scale


def _clip_per_field(raw: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Clip each field's raw index into ``[0, sizes[f]-1]``: an out-of-range
    index resolves to its field's last row."""
    hi = constant(tuple(max(int(n) - 1, 0) for n in sizes), raw.dtype, raw.device)
    return torch.minimum(raw.clamp(min=0), hi)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor of any shape → ``idx.shape + (E,)``."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])


class _FieldGather(torch.autograd.Function):
    """The gather of :func:`_field_gather` with its own backward
    (``xsdeepfwfm_deprecated_tpu/ops/embedding.py:342-381``): fields of more
    than one row scatter-add their cotangents into a zero table gradient;
    a single-row field (a numeric slot, the dummy route of a QR field) adds
    the batch-sum of its cotangents at its static row, instead of B atomic
    adds to one row. The gradient has the table's dtype. No index gets one."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, raw: torch.Tensor, offsets: Tuple[int, ...],
                sizes: Tuple[int, ...]) -> torch.Tensor:
        offs = constant(offsets, raw.dtype, raw.device)
        idx = (_clip_per_field(raw, sizes) + offs).clamp(0, table.shape[0] - 1)
        ctx.save_for_backward(idx)
        ctx.layout = (offsets, sizes, table.shape, table.dtype)
        return _take(table, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        offsets, sizes, shape, dtype = ctx.layout
        g = g.to(dtype)
        grad = g.new_zeros(shape)
        multi = tuple(f for f, n in enumerate(sizes) if n > 1)
        single = tuple(f for f, n in enumerate(sizes) if n <= 1)
        if multi:
            cols = constant(multi, torch.long, g.device)
            grad.index_add_(0, idx.index_select(1, cols).reshape(-1),
                            g.index_select(1, cols).reshape(-1, shape[1]))
        if single:
            cols = constant(single, torch.long, g.device)
            rows = constant(tuple(min(max(offsets[f], 0), shape[0] - 1) for f in single),
                            idx.dtype, g.device)
            grad.index_add_(0, rows, g.index_select(1, cols).sum(dim=0))
        return grad, None, None, None


def _field_gather(table: torch.Tensor, offsets: Sequence[int], sizes: Sequence[int],
                  raw: torch.Tensor) -> torch.Tensor:
    """``out[:, f] = table[clip(offsets[f] + clip_f(raw[:, f]))]``, (B, F) → (B, F, E)."""
    return _FieldGather.apply(table, raw, tuple(offsets), tuple(int(n) for n in sizes))


def _combine_qr(op: str, q_emb: torch.Tensor, r_emb: torch.Tensor) -> torch.Tensor:
    if op == "mult":
        return q_emb * r_emb
    if op == "add":
        return q_emb + r_emb
    return torch.cat([q_emb, r_emb], dim=-1)   # concat (split-E variant)


def _qr_gather(tables: Dict[str, torch.Tensor], spec: PackedEmbeddingSpec,
               raw: torch.Tensor) -> torch.Tensor:
    """Quotient/remainder split and combine. Indices clip per field BEFORE
    the split, so an out-of-range index resolves to the last row's (q, r)."""
    c = spec.qr_collisions
    raw = _clip_per_field(raw, spec.feature_sizes)
    q_sizes = tuple(-(-n // c) if qr else 1
                    for n, qr in zip(spec.feature_sizes, spec.is_qr_field))
    r_sizes = tuple(c if qr else 1 for qr in spec.is_qr_field)
    q_emb = _field_gather(tables["q"], spec.q_offsets, q_sizes, raw // c)
    r_emb = _field_gather(tables["r"], spec.r_offsets, r_sizes, raw % c)
    return _combine_qr(spec.qr_operation, q_emb, r_emb)


def _qr_mask(spec: PackedEmbeddingSpec, fields: slice, device: torch.device) -> torch.Tensor:
    return constant(spec.is_qr_field[fields], torch.bool, device)[None, :, None]


def packed_lookup(tables: Dict[str, torch.Tensor], spec: PackedEmbeddingSpec,
                  xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Fused lookup → (B, F, E) field embeddings, values pre-scaled. The
    value-scale multiply also upcasts bf16-stored tables to float32."""
    raw, scale = build_indices(spec, xi, xv)
    # QR fields have no dense rows: a single-row route whose value the
    # where() below discards
    sizes = tuple(1 if qr else n for n, qr in zip(spec.feature_sizes, spec.is_qr_field))
    emb = _field_gather(tables["dense"], spec.dense_offsets, sizes, raw)
    if spec.has_qr:
        emb = torch.where(_qr_mask(spec, slice(None), raw.device),
                          _qr_gather(tables, spec, raw), emb)
    return emb * scale[..., None]


def packed_lookup_serving(tables: Dict[str, torch.Tensor], spec: PackedEmbeddingSpec,
                          xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Serving form of :func:`packed_lookup`, same result: the numeric rows
    are a static slice (no gather), the categorical fields one clipped gather."""
    num = spec.numerical
    if not all(n == 1 for n in spec.feature_sizes[:num]):
        raise ValueError("numeric fields must be leading single-row slots")
    dense = tables["dense"]
    xi = _clip_per_field(xi, spec.feature_sizes[num:])
    parts = []
    if num:
        parts.append(xv[..., None] * dense[:num][None])                # (B, num, E)
    cat_offs = constant(spec.dense_offsets[num:], xi.dtype, xi.device)
    out_cat = _take(dense, (xi + cat_offs).clamp(0, dense.shape[0] - 1))   # (B, C, E)
    if spec.has_qr:
        c = spec.qr_collisions
        q_offs = constant(spec.q_offsets[num:], xi.dtype, xi.device)
        r_offs = constant(spec.r_offsets[num:], xi.dtype, xi.device)
        q_emb = _take(tables["q"], (q_offs + xi // c).clamp(0, tables["q"].shape[0] - 1))
        r_emb = _take(tables["r"], (r_offs + xi % c).clamp(0, tables["r"].shape[0] - 1))
        out_cat = torch.where(_qr_mask(spec, slice(num, None), xi.device),
                              _combine_qr(spec.qr_operation, q_emb, r_emb), out_cat)
    parts.append(out_cat.to(xv.dtype))   # bf16 tables → compute dtype
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def table_param_count(tables: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() for t in tables.values()))
