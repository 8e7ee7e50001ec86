"""Packed embedding tables: one gather over all fields.

Port of ``xsdeepfwfm_deprecated_tpu/ops/embedding.py``. All per-field tables
are packed into one ``(sum(feature_sizes), E)`` table with static per-field
row offsets, so a lookup is one gather of shape ``(B, F)`` → ``(B, F, E)``.
A numeric field has one row, scaled by the raw value. QR (quotient-remainder)
fields read packed quotient and remainder tables instead of the dense one.

The training lookup has its own backward (:class:`_FieldGather`); the
serving lookup is forward-only.

DLRM-DCNv2's multi-hot bags (:class:`BagSpec`, :func:`bag_lookup`) are the
same packed table over its categorical fields alone, each field a bag of a
fixed number of ids whose rows are summed. In a training step the lookup
records its ids and hands autograd a leaf of its own for the pooled bags
(:func:`recording_bags`), so that the backward gives the update the bags'
gradient (:class:`BagGrad`) and nothing the size of the table;
:func:`bag_adagrad_` then sums the gradients of equal ids and steps Adagrad
on the batch's distinct rows alone, with no host sync: on the card as the
kernel of ``ops/cuda/bag_adagrad``, on the CPU in fixed-size torch passes.

Not ported, because they are TPU gather workarounds that leave the result
unchanged: the routed and windowed gathers (``:161-339``) and the grouped
serving layout (``:487-560``). Every lookup here is one flat ``index_select``.
Out-of-range indices resolve to their field's last row, as in JAX.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import constant, scaled_normal
from .cuda.bag_adagrad import bag_adagrad


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


# ------------------------------------------------- DLRM-DCNv2's multi-hot bags

@dataclass(frozen=True)
class BagSpec:
    """Static layout of the bags: field f holds ``bag_sizes[f]`` consecutive
    columns of a row's ids and ``feature_sizes[f]`` packed rows from
    ``offsets[f]``."""

    feature_sizes: Tuple[int, ...]
    bag_sizes: Tuple[int, ...]

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, at = [], 0
        for n in self.feature_sizes:
            out.append(at)
            at += n
        return tuple(out)

    @property
    def rows(self) -> int:
        return sum(self.feature_sizes)

    @property
    def columns(self) -> int:
        return sum(self.bag_sizes)

    @property
    def starts(self) -> Tuple[int, ...]:
        """Each field's first column."""
        return tuple(sum(self.bag_sizes[:f]) for f in range(len(self.bag_sizes)))

    @property
    def column_field(self) -> Tuple[int, ...]:
        return tuple(f for f, k in enumerate(self.bag_sizes) for _ in range(k))


def bag_spec(feature_sizes: Sequence[int], numerical: int,
             bag_sizes: Sequence[int]) -> BagSpec:
    """The bags of the categorical fields (the ``numerical`` leading fields
    have no rows)."""
    return BagSpec(tuple(int(n) for n in feature_sizes[numerical:]),
                   tuple(int(k) for k in bag_sizes))


def bag_rows(spec: BagSpec, xi: torch.Tensor, table_rows: int) -> torch.Tensor:
    """(B, columns) ids → their packed rows, int64: each id clipped into its
    field's rows, then clipped to the table's (a warm-up reads a one-row
    stand-in of the table, ``train.trainer``)."""
    col = spec.column_field
    sizes = tuple(spec.feature_sizes[f] for f in col)
    offs = constant(tuple(spec.offsets[f] for f in col), torch.long, xi.device)
    return (_clip_per_field(xi.long(), sizes) + offs).clamp(0, table_rows - 1)


@dataclass
class BagRecord:
    """One pooled lookup of a training forward: the table it read, its rows
    (B, columns) and the pooled bags (B, fields, E), a leaf of autograd's."""
    table: torch.Tensor
    rows: torch.Tensor
    pooled: torch.Tensor
    spec: BagSpec


@dataclass
class BagTape:
    records: List[BagRecord] = field(default_factory=list)


_TAPE = threading.local()


@contextlib.contextmanager
def recording_bags() -> Iterator[BagTape]:
    """Record the pooled lookups of the forward run inside: each returns a
    leaf of autograd's for its bags, cut from the table, so that the
    gradient stops there (``train.trainer.loss_and_grads``)."""
    prev, _TAPE.tape = getattr(_TAPE, "tape", None), BagTape()
    try:
        yield _TAPE.tape
    finally:
        _TAPE.tape = prev


def _row_major(batch: int, stride: int, per_row: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """``row * stride + per_row[j]`` for each row in turn and every j, int64,
    made on the device: at the benchmark's batch these hold millions."""
    rows = torch.arange(batch, dtype=torch.long, device=device)[:, None] * stride
    return (rows + constant(tuple(per_row), torch.long, device)[None, :]).reshape(-1)


def bag_lookup(table: torch.Tensor, spec: BagSpec, xi: torch.Tensor) -> torch.Tensor:
    """(B, columns) ids → (B, fields, E): each field's rows summed, one
    ``embedding_bag`` over every bag. Inside :func:`recording_bags` the
    result is a leaf of autograd's and the lookup is recorded; elsewhere
    autograd reaches the table through ``embedding_bag``'s own backward."""
    b = xi.shape[0]
    rows = bag_rows(spec, xi, table.shape[0])
    offsets = _row_major(b, spec.columns, spec.starts, xi.device)   # each (row, field) bag's start
    tape = getattr(_TAPE, "tape", None)
    if tape is None:
        return F.embedding_bag(rows.reshape(-1), table, offsets, mode="sum").view(b, -1,
                                                                                  table.shape[1])
    with torch.no_grad():
        pooled = F.embedding_bag(rows.reshape(-1), table, offsets, mode="sum")
    pooled = pooled.view(b, -1, table.shape[1]).requires_grad_(True)
    tape.records.append(BagRecord(table, rows, pooled, spec))
    return pooled


@dataclass
class BagGrad:
    """A bag table's gradient as the backward leaves it: the rows each id
    read (B, columns) and the gradient of each pooled bag (B, fields, E)."""
    rows: torch.Tensor
    grad: torch.Tensor
    spec: BagSpec


@torch.no_grad()
def bag_adagrad_(table: torch.Tensor, acc: torch.Tensor, g: BagGrad, lr: float,
                 eps: float, count: torch.Tensor) -> None:
    """Adagrad (``acc += g²``; ``w -= lr·g·rsqrt(acc + eps)`` where acc > 0)
    on the rows the batch read, in place, the gradients of equal ids summed
    first: what the dense rule gives, since every other row's gradient is 0.
    ``count`` (int64, on the device) gains the number of distinct rows.

    On the card the kernel of ``ops/cuda/bag_adagrad`` (which raises on what it
    does not take): each distinct row's gradients summed in registers in
    position order and the row stepped once. On the CPU
    :func:`bag_adagrad_torch`."""
    if table.device.type == "cuda":
        bag_adagrad(table, acc, g.rows, g.grad, g.spec.column_field, lr, eps, count)
    else:
        bag_adagrad_torch(table, acc, g, lr, eps, count)


@torch.no_grad()
def bag_adagrad_torch(table: torch.Tensor, acc: torch.Tensor, g: BagGrad, lr: float,
                      eps: float, count: torch.Tensor) -> None:
    """:func:`bag_adagrad_` in torch passes of fixed sizes, with no host sync:
    the N = B·columns rows are sorted, each distinct row is a segment, and N
    slots hold the segments' rows and summed gradients. A slot past the last
    segment keeps its sorted row with a zero gradient, which adds exactly
    nothing (and spreads those adds over many rows, where one row would take
    them all in turn). Each column's gradients are added into their segments
    straight from the bags', one column a launch, so no (N, E) copy of them is
    made."""
    b, fields, e = g.grad.shape
    ids = g.rows.reshape(-1)
    n = ids.numel()
    sorted_ids, perm = torch.sort(ids)
    new = torch.ones_like(sorted_ids, dtype=torch.bool)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new, 0) - 1                                  # sorted slot → segment
    seg_of = torch.empty_like(seg).scatter_(0, perm, seg).view(b, -1)   # id → its segment
    rows = sorted_ids.clone().scatter_(0, seg, sorted_ids)          # segment → its row
    gsum = torch.zeros((n, e), dtype=g.grad.dtype, device=ids.device)
    for c, f in enumerate(g.spec.column_field):
        gsum.index_add_(0, seg_of[:, c], g.grad[:, f])
    a = acc.index_select(0, rows)
    sq = gsum * gsum
    a.add_(sq)                                                      # each row's acc after
    acc.index_add_(0, rows, sq)
    del sq
    live = a > 0
    upd = a.add_(eps).rsqrt_().mul_(gsum).masked_fill_(~live, 0.0)
    table.index_add_(0, rows, upd, alpha=-lr)
    count.add_(seg[-1] + 1)
