"""Row-sharded embedding lookups with the exchange between ranks written out.

Port of ``xsdeepfwfm_deprecated_tpu/parallel/embedding_sharding.py``. The
dense packed table's rows are cut into contiguous blocks, one per rank of the
table's axes (:func:`.mesh.shard_params`); each exchange is a
``torch.autograd.Function`` over ``torch.distributed`` collectives
(:class:`.mesh.Mesh` methods), one process per rank:

* **psum** (``:42-59``): the batch is sharded over ``data`` and repeats along
  ``model``. Each rank gathers the hits of its own rows, zero for the rest,
  and one all-reduce (sum) over the model group combines them: every global
  row lives on exactly one block, so the sum is the select. The backward is
  the identity: every model rank holds the same rows and so receives the same
  upstream gradient, which it scatter-adds into its own block. No all-reduce
  in the backward (``:53-56``: that would double the traffic).
* **a2a** (``:100-130``): the batch is sharded over both axes. An all-gather
  of the model group's index blocks (int32), a gather of this rank's rows
  for every sibling's indices, an all-to-all that returns to each rank its
  own examples' vectors, a sum over the received slots (one of which is not
  zero). The backward is the reverse all-to-all of the gradient, then
  ``index_add_`` into the local block.
* **a2a_grid** (``:273-321``): the same over the world group, with the rows
  sharded over every rank, so no table-sized gradient all-reduce exists.

Each lookup clips an index to its field and then to the real rows of the
table, so no index reaches a pad row (JAX's sharded lookups clip only to the
padded table, ``:73-75``: the same on every index inside its field). The QR
tables stay replicated (``:85-91``) and the numeric value scales its row.
The index all-gather of a forward is made once and shared by its tables, as
XLA shares it in JAX.

Not ported: the super-row variants (``:133-186``), a layout with the same
logits; ``-mesh_table_layout super`` trains the flat table.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..device import constant
from ..ops import embedding as emb_ops
from ..ops.embedding import PackedEmbeddingSpec
from .mesh import GRID_AXES, MODEL_AXIS, Axes, Mesh

LookupFn = Callable[[Dict[str, torch.Tensor], PackedEmbeddingSpec, torch.Tensor, torch.Tensor],
                    torch.Tensor]


def _own_rows(table: torch.Tensor, gidx: torch.Tensor, index: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row within this rank's block, clamped; whether the block holds it)."""
    rows = table.shape[0]
    local = gidx - index * rows
    valid = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), valid


def _masked_take(table: torch.Tensor, local: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    got = emb_ops._take(table, local)
    return torch.where(valid[..., None], got, torch.zeros_like(got))


def _scatter_add(shape, dtype, local: torch.Tensor, valid: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """The block's gradient: ``g`` added at the rows this block holds. The
    others add an exact zero at a clamped row, which keeps the host from
    waiting for a count of the valid entries."""
    g = torch.where(valid[..., None], g, torch.zeros_like(g)).to(dtype)
    grad = g.new_zeros(shape)
    grad.index_add_(0, local.reshape(-1), g.reshape(-1, shape[1]))
    return grad


class PsumExchange(torch.autograd.Function):
    """``(table block, global indices (b, F))`` → ``(b, F, E)``, the same on
    every rank of the model group."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, gidx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        local, valid = _own_rows(table, gidx, mesh.axis_index(MODEL_AXIS))
        ctx.save_for_backward(local, valid)
        ctx.layout = (table.shape, table.dtype)
        return mesh.all_reduce(_masked_take(table, local, valid), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        local, valid = ctx.saved_tensors
        return _scatter_add(*ctx.layout, local, valid, g), None, None


class AllToAllExchange(torch.autograd.Function):
    """``(table block, the group's indices (n, b, F))`` → this rank's
    ``(b, F, E)``, over the ranks of ``axes`` (``model`` for a2a, the grid
    for a2a_grid)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, group_idx: torch.Tensor, mesh: Mesh,
                axes: Axes) -> torch.Tensor:
        local, valid = _own_rows(table, group_idx, mesh.axis_index(axes))
        ctx.save_for_backward(local, valid)
        ctx.layout = (table.shape, table.dtype)
        ctx.mesh, ctx.axes = mesh, axes
        recv = mesh.all_to_all(_masked_take(table, local, valid), axes)    # (n, b, F, E)
        return recv.sum(dim=0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        local, valid = ctx.saved_tensors
        n = local.shape[0]
        # every slot of the forward's sum has the gradient g; the reverse exchange
        # brings each rank the gradients of the rows it sent
        sent = ctx.mesh.all_to_all(g.unsqueeze(0).expand(n, *g.shape), ctx.axes)
        return _scatter_add(*ctx.layout, local, valid, sent), None, None, None


def _global_indices(spec: PackedEmbeddingSpec, raw: torch.Tensor) -> torch.Tensor:
    """Packed row of each ``(example, field)``: the index clipped to its field
    (a QR field to its unused single-row route), then to the real rows."""
    sizes = tuple(1 if qr else n for n, qr in zip(spec.feature_sizes, spec.is_qr_field))
    offs = constant(spec.dense_offsets, raw.dtype, raw.device)
    return (emb_ops._clip_per_field(raw, sizes) + offs).clamp(0, max(spec.dense_rows, 1) - 1)


def _make_lookup(mesh: Mesh, exchange: str, axes: Axes) -> LookupFn:
    shared: Dict[str, Optional[torch.Tensor]] = {"xi": None, "idx": None}

    def lookup(tables: Dict[str, torch.Tensor], spec: PackedEmbeddingSpec,
               xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        raw, scale = emb_ops.build_indices(spec, xi, xv)
        if exchange == "psum":
            emb = PsumExchange.apply(tables["dense"], _global_indices(spec, raw), mesh)
        else:
            if shared["xi"] is not xi:     # one index exchange for the tables of a forward
                shared["xi"], shared["idx"] = xi, mesh.all_gather(_global_indices(spec, raw), axes)
            emb = AllToAllExchange.apply(tables["dense"], shared["idx"], mesh, axes)
        if spec.has_qr:
            emb = torch.where(emb_ops._qr_mask(spec, slice(None), raw.device),
                              emb_ops._qr_gather(tables, spec, raw), emb)
        return emb * scale[..., None]

    return lookup


def make_sharded_lookup(mesh: Mesh, spec: PackedEmbeddingSpec) -> LookupFn:
    """The psum exchange: tables row-sharded over ``model``, batch over ``data``.
    A drop-in ``lookup_fn`` for ``models.deepfwfm.forward`` on this rank's
    rows and blocks. ``spec`` is taken for the JAX signature; the lookup
    reads the one it is called with."""
    return _make_lookup(mesh, "psum", MODEL_AXIS)


def make_a2a_lookup(mesh: Mesh, spec: PackedEmbeddingSpec) -> LookupFn:
    """The model-axis all-to-all exchange: tables over ``model``, batch over
    both axes, so the dense compute after the lookup is data-parallel over
    the whole grid."""
    return _make_lookup(mesh, "a2a", MODEL_AXIS)


def make_grid_lookup(mesh: Mesh, spec: PackedEmbeddingSpec) -> LookupFn:
    """The all-to-all exchange with the table rows sharded over every rank:
    the model-axis exchanges repeat each block along ``data`` and must
    all-reduce its gradient there every step (``rows_local·E·4`` bytes a
    table; 26.5 MB at full-Criteo scale on a (2, 2) mesh); here every row and
    its optimizer moments live on one rank, its gradient arrives through the
    backward all-to-all, and no table-sized collective exists. The default."""
    return _make_lookup(mesh, "a2a_grid", GRID_AXES)


def setup_exchange(mesh: Mesh, spec: PackedEmbeddingSpec, exchange: str):
    """The one resolver of an exchange's wiring (``:237-263``). Returns
    ``(lookup_fn, table_axes, table_shards, batch_over_both)``. ``lookup_fn``
    is None where the exchange degenerates to replicated tables (a2a or psum
    with ``model == 1``: pure data parallelism); ``table_axes`` and
    ``table_shards`` say how the tables are cut; ``batch_over_both`` whether
    the batch spans both axes (the all-to-all family) or ``data`` only."""
    m, n = mesh.model, mesh.size
    if exchange == "a2a_grid":
        if n > 1:
            return make_grid_lookup(mesh, spec), GRID_AXES, n, True
        return None, MODEL_AXIS, 1, True
    if exchange == "a2a":
        if m > 1:
            return make_a2a_lookup(mesh, spec), MODEL_AXIS, m, True
        return None, MODEL_AXIS, 1, False
    if exchange == "psum":
        if m > 1:
            return make_sharded_lookup(mesh, spec), MODEL_AXIS, m, False
        return None, MODEL_AXIS, 1, False
    raise ValueError(f"unknown exchange {exchange!r} (a2a_grid | a2a | psum)")
