"""DLRM-DCNv2's bags over the ranks of a mesh: the large tables row-wise, the
small ones whole on every rank, with the exchanges of a step written out.

The port's own (the JAX package has no multi-hot bags). The placement is the
one torchrec gives MLPerf's deployment: a table of more than ``threshold``
rows (``ModelConfig.bag_row_wise_rows``, 1,000,000) is cut into one
contiguous block of ``ceil(rows / ranks)`` rows a rank; every other table is
held whole on every rank. A rank's table (the leaf ``bags/dense``, and its
Adagrad accumulator alike) holds the whole tables first, in field order, then
its block of each row-wise table, then one row of zeros that no step writes
(the sink, its last row): at Criteo 1TB on four ranks 1,116,632 + 5 x
10,000,000 + 766,989 rows and the sink.

The batch is sharded over the ranks (``-mesh_data``), each rank a block of
``b`` rows of the global batch, in rank order. One step of a rank
(:meth:`ShardedBags.lookup` in the forward, :class:`..ops.embedding.BagRecord`'s
``exchange`` in the backward, :meth:`ShardedBags.reduce` before the
optimizer), each collective in a span of its own:

1. ``Bags - Ids Exchange``: an all-gather of every rank's ids, (ranks·b,
   columns) int32, a fixed shape (an all-to-all of the row-wise fields' ids to
   their owners would have a size that changes with the batch, which a CUDA
   graph cannot hold). Each id becomes a row of this rank's table: a whole
   table's row, a row of its block, or the sink where another rank holds it.
2. ``Bags - Lookup``: the row-wise fields' bags of the whole global batch
   pooled from this rank's blocks (a bag's ids held elsewhere read the sink's
   zeros), and the whole tables' bags of this rank's own rows, each one
   ``embedding_bag``.
3. ``Bags - Pool Exchange``: a reduce-scatter of the row-wise fields' partial
   bags, (ranks, b, fields, E), which leaves each rank the sum of every
   block's part for its own rows.
4. ``Bags - Grad Exchange``: in the backward, an all-gather of the gradient
   of this rank's pooled bags, every field's, so that each rank holds the
   global batch's bag gradients beside its ids. Its sparse Adagrad
   (:func:`..ops.embedding.bag_adagrad_`) then steps its blocks' rows that the
   batch read and the whole tables' rows, the sink's ids left
   (``BagGrad.skip``): every rank applies the same update to its whole
   tables, from the same ids and gradients in the same order, so that they
   stay equal to the bit.
5. ``Dense - All Reduce``: the dense arch's, the cross network's and the over
   arch's gradients summed over the ranks, one all-reduce.

The step is then the one-process step of the global batch: each rank's loss is
its rows' summed cross-entropy over the global batch's row count
(``train.trainer.batch_loss``), so the gradients sum to the global mean's.
Outside a training step (eval) the lookup runs steps 1 to 3 without a
gradient.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F

from .. import _tree
from ..device import constant
from ..models.dlrm import is_bag_state
from ..ops import embedding as emb_ops
from ..ops.embedding import BagSpec
from ..utils import profiling
from .mesh import GRID_AXES, Mesh, reduce_gradients

_NEVER = 1 << 62        # a whole table's block: every id falls in block 0


@dataclass(frozen=True)
class BagPlacement:
    """Where rank ``rank`` of ``ranks`` holds each table's rows. Field f's
    global id ``i`` (clipped into its rows) is a row of this rank's table
    where f is whole (``local_offsets[f] + i``) or where ``i // block[f] ==
    rank`` (``local_offsets[f] + i - rank·block[f]``)."""

    spec: BagSpec
    ranks: int
    rank: int
    threshold: int

    @property
    def row_wise(self) -> Tuple[bool, ...]:
        return tuple(self.ranks > 1 and n > self.threshold for n in self.spec.feature_sizes)

    @property
    def blocks(self) -> Tuple[int, ...]:
        """Rows a rank holds of each field."""
        return tuple(-(-n // self.ranks) if rw else n
                     for n, rw in zip(self.spec.feature_sizes, self.row_wise))

    @property
    def local_offsets(self) -> Tuple[int, ...]:
        """Each field's first row in this rank's table: the whole tables, then
        the blocks."""
        out, at = [0] * len(self.blocks), 0
        for want in (False, True):
            for f, (n, rw) in enumerate(zip(self.blocks, self.row_wise)):
                if rw == want:
                    out[f], at = at, at + n
        return tuple(out)

    @property
    def whole_rows(self) -> int:
        """The rows of the tables every rank holds whole: the first of its table."""
        return sum(n for n, rw in zip(self.blocks, self.row_wise) if not rw)

    @property
    def rows(self) -> int:
        """This rank's table: the whole tables, its blocks and the sink."""
        return sum(self.blocks) + 1

    def held(self, f: int) -> Tuple[int, int]:
        """The global ids [lo, hi) of field f that this rank holds."""
        n = self.spec.feature_sizes[f]
        if not self.row_wise[f]:
            return 0, n
        blk = self.blocks[f]
        return min(self.rank * blk, n), min((self.rank + 1) * blk, n)

    def columns_of(self, row_wise: bool) -> Tuple[int, ...]:
        return tuple(c for c, f in enumerate(self.spec.column_field)
                     if self.row_wise[f] == row_wise)

    def fields_of(self, row_wise: bool) -> Tuple[int, ...]:
        return tuple(f for f, rw in enumerate(self.row_wise) if rw == row_wise)


def _per_field(p: BagPlacement, dev) -> torch.Tensor:
    """(4, fields) int64: each field's last id, the block its ids divide by
    (a whole table's: one block), the block this rank holds, and the row of
    this rank's table that the field's id 0 would take."""
    sizes = p.spec.feature_sizes
    return constant((tuple(n - 1 for n in sizes),
                     tuple(blk if rw else _NEVER for blk, rw in zip(p.blocks, p.row_wise)),
                     tuple(p.rank if rw else 0 for rw in p.row_wise),
                     tuple(off - (p.rank * blk if rw else 0)
                           for off, blk, rw in zip(p.local_offsets, p.blocks, p.row_wise))),
                    torch.long, dev)


def _to_local(ids: torch.Tensor, hi, div, want, base, table_rows: int) -> torch.Tensor:
    """Each id clipped into its field's rows, then its row of the rank's table
    where the rank holds it, else the table's last row (the sink), then
    clipped to the table's rows (a warm-up reads a one-row stand-in,
    ``utils.cuda_graph.Compiled``)."""
    i = torch.minimum(ids.long().clamp(min=0), hi)
    sink = table_rows - 1
    return torch.where(torch.div(i, div, rounding_mode="floor") == want, base + i,
                       sink).clamp_(max=sink)


def local_rows(placement: BagPlacement, ids: torch.Tensor, table_rows: int) -> torch.Tensor:
    """(N, columns) ids → rows of a rank's table (int64), the sink's where the
    rank does not hold them."""
    col = constant(placement.spec.column_field, torch.long, ids.device)
    return _to_local(ids, *_per_field(placement, ids.device).index_select(1, col), table_rows)


def packed_to_local(placement: BagPlacement, rows: torch.Tensor, table_rows: int) -> torch.Tensor:
    """Rows of the whole packed table (any shape) → rows of a rank's table
    (int64), the sink's where the rank does not hold them."""
    offsets = constant(placement.spec.offsets, torch.long, rows.device)
    field = torch.searchsorted(offsets, rows.long(), right=True) - 1
    per = _per_field(placement, rows.device)[:, field.reshape(-1)].view(4, *rows.shape)
    return _to_local(rows.long() - offsets[field], *per, table_rows)


def local_table(placement: BagPlacement, rows_of: Callable[[int, int], torch.Tensor],
                width: int, dtype: torch.dtype, device) -> torch.Tensor:
    """This rank's table, each held row range copied from ``rows_of(lo, hi)``
    (the global packed rows [lo, hi), (hi - lo, width)); pad rows and the sink
    are zeros."""
    out = torch.zeros((placement.rows, width), dtype=dtype, device=device)
    for f, off in enumerate(placement.spec.offsets):
        lo, hi = placement.held(f)
        at = placement.local_offsets[f]
        if hi > lo:
            out[at:at + hi - lo] = rows_of(off + lo, off + hi)
    return out


def room_bytes(device: torch.device) -> int:
    """The memory free on ``device`` now: the card's, or the host's."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


class ShardedBags:
    """The bags of DLRM-DCNv2 (``spec``, the whole model's) over every rank of
    ``mesh``, tables of more than ``threshold`` rows row-wise: what a rank's
    sharded step binds (:meth:`lookup` as ``models.dlrm.forward``'s
    ``lookup_fn``, :meth:`reduce` as the step's gradient reduction) and how its
    state is cut and gathered (:meth:`shard`, :meth:`gather`)."""

    def __init__(self, mesh: Mesh, spec: BagSpec, threshold: int):
        self.mesh, self.spec = mesh, spec
        self.placement = BagPlacement(spec, mesh.size, mesh.rank, int(threshold))

    # ------------------------------------------------------------ the step

    def _pool(self, table: torch.Tensor, rows: torch.Tensor, row_wise: bool) -> torch.Tensor:
        """The bags of the fields that are (or are not) ``row_wise``, from the
        rows (N, columns) of this rank's table: (N, those fields, E)."""
        p = self.placement
        cols = p.columns_of(row_wise)
        sizes = [self.spec.bag_sizes[f] for f in p.fields_of(row_wise)]
        picked = rows.index_select(1, constant(cols, torch.long, rows.device))
        starts = tuple(sum(sizes[:j]) for j in range(len(sizes)))
        offsets = emb_ops._row_major(rows.shape[0], len(cols), starts, rows.device)
        return F.embedding_bag(picked.reshape(-1), table, offsets,
                               mode="sum").view(rows.shape[0], len(sizes), table.shape[1])

    def lookup(self, table: torch.Tensor, spec: BagSpec, xi: torch.Tensor) -> torch.Tensor:
        """(b, columns) ids of this rank's rows → their bags (b, fields, E), as
        ``ops.embedding.bag_lookup`` gives them from the whole table; inside
        ``ops.embedding.recording_bags`` a leaf of autograd's, recorded with
        the exchange of its gradient."""
        tape = getattr(emb_ops._TAPE, "tape", None)
        if tape is None and torch.is_grad_enabled() and table.requires_grad:
            raise ValueError("a sharded bag lookup gives the table its gradient inside a train "
                             "step (ops.embedding.recording_bags) only")
        mesh, p = self.mesh, self.placement
        b, n = xi.shape[0], mesh.size
        with profiling.named_scope(profiling.SCOPE_BAGS_IDS_EXCHANGE):
            every = mesh.all_gather(xi.to(torch.int32), GRID_AXES).view(n * b, -1)
        with torch.no_grad():
            rows = local_rows(p, every, table.shape[0])
            row_wise, whole = p.fields_of(True), p.fields_of(False)
            with profiling.named_scope(profiling.SCOPE_BAGS_LOOKUP):
                part = self._pool(table, rows, True) if row_wise else None
                mine = (self._pool(table, rows[p.rank * b:(p.rank + 1) * b], False)
                        if whole else None)
            pooled = table.new_empty((b, len(spec.bag_sizes), table.shape[1]))
            if row_wise:
                with profiling.named_scope(profiling.SCOPE_BAGS_POOL_EXCHANGE):
                    got = mesh.reduce_scatter(part.view(n, b, len(row_wise), -1), GRID_AXES)
                pooled.index_copy_(1, constant(row_wise, torch.long, xi.device), got)
            if whole:
                pooled.index_copy_(1, constant(whole, torch.long, xi.device), mine)
        if tape is None:
            return pooled
        pooled.requires_grad_(True)
        tape.records.append(emb_ops.BagRecord(
            table, rows, pooled, spec,
            exchange=partial(self._grad, rows, spec, table.shape[0] - 1)))
        return pooled

    def _grad(self, rows: torch.Tensor, spec: BagSpec, sink: int,
              g: torch.Tensor) -> emb_ops.BagGrad:
        """The bags' gradient of every rank's rows beside the global batch's
        rows of this rank's table, the sink's ids left to the other ranks."""
        with profiling.named_scope(profiling.SCOPE_BAGS_GRAD_EXCHANGE):
            every = self.mesh.all_gather(g, GRID_AXES).view(rows.shape[0], *g.shape[1:])
        return emb_ops.BagGrad(rows, every, spec, skip=sink)

    def reduce(self, grads: List[Any]) -> None:
        """Sum the dense leaves' gradients over the ranks, in place (the bag
        table's was exchanged in the backward)."""
        with profiling.named_scope(profiling.SCOPE_DENSE_ALL_REDUCE):
            reduce_gradients(self.mesh, grads, [None] * len(grads), batch=GRID_AXES)

    # --------------------------------------------------------------- state

    def _is_table(self, path: str, leaf: Any) -> bool:
        return is_bag_state(path) and getattr(leaf, "ndim", 0) == 2

    def shard(self, tree: Any) -> Any:
        """``tree`` (parameters or optimizer state) with each whole bag table,
        (``spec.rows``, E), replaced by this rank's table."""
        p = self.placement

        def cut(path, leaf):
            if not self._is_table(path, leaf):
                return leaf
            return local_table(p, lambda lo, hi: leaf[lo:hi], leaf.shape[1], leaf.dtype,
                               leaf.device)
        return _tree.tree_map_with_path(cut, tree)

    def gather(self, tree: Any) -> Any:
        """Inverse of :meth:`shard` (collective): every bag table whole on
        every rank. Raises a ``ValueError`` that names the sizes where the
        device cannot hold the whole tables beside the gather's buffers."""
        tables = [leaf for path, leaf in _tree.named_leaves(tree) if self._is_table(path, leaf)]
        if not tables:
            return tree
        p, n = self.placement, self.mesh.size
        width, item = tables[0].shape[1], tables[0].element_size()
        whole = self.spec.rows * width * item
        need = len(tables) * whole + n * p.rows * width * item
        room = room_bytes(tables[0].device)
        if need > room:
            raise ValueError(
                f"the whole bag tables do not fit on {tables[0].device}: {len(tables)} of "
                f"{self.spec.rows:,} rows x {width} ({whole / 1e9:.2f} GB each) and the "
                f"gather's {n} x {p.rows:,} rows need {need / 1e9:.2f} GB, {room / 1e9:.2f} GB "
                f"is free; the sharded model stays on its ranks")

        def join(path, leaf):
            if not self._is_table(path, leaf):
                return leaf
            parts = self.mesh.all_gather(leaf, GRID_AXES)       # (ranks, rows, E)
            out = leaf.new_empty((self.spec.rows, width))
            for r in range(n):
                q = BagPlacement(self.spec, n, r, p.threshold)
                for f, off in enumerate(self.spec.offsets):
                    lo, hi = q.held(f)
                    if hi > lo and (q.row_wise[f] or r == 0):
                        at = q.local_offsets[f]
                        out[off + lo:off + hi] = parts[r, at:at + hi - lo]
            return out
        return _tree.tree_map_with_path(join, tree)
