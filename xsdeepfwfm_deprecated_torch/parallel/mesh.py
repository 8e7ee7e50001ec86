"""The ``(data, model)`` rank mesh of a sharded fit, over ``torch.distributed``.

Port of ``xsdeepfwfm_deprecated_tpu/parallel/mesh.py``. The execution model
differs from JAX's, and everything here follows from it: JAX has one
controller that drives every device through ``shard_map``; the port is SPMD,
one process per rank, each running the same program on its own device, with
every collective written out (:mod:`.embedding_sharding` for the lookup
exchange, :func:`reduce_gradients` for the gradients that JAX reduces
implicitly).

* **Rank layout**, as JAX's ``np.asarray(devices).reshape(data, model)``
  (``:42``): rank ``r`` is ``(d, m) = divmod(r, model)``. A batch sharded
  over both axes gives rank ``r`` the global rows ``[r·b, (r+1)·b)``; over
  ``data`` only, rank ``(d, m)`` the rows ``[d·b, (d+1)·b)`` on every ``m``.
  A table sharded over ``model`` puts row block ``m`` on the ranks ``(·, m)``;
  over the grid, block ``r`` on rank ``r``. So a rank's block compares with
  the JAX shard of the same index.
* **Groups**: the world; the data group (the ranks that share a model
  index); the model group (the ranks that share a data index). Every rank
  makes every group with ``dist.new_group``, in the same order.
* **Starting the ranks** is the caller's: ``torchrun``, or
  :func:`.launch.run_ranks` (``torch.multiprocessing`` with ``spawn``). Each
  rank calls :func:`init_distributed` and passes its own device.
* **Backend**: ``nccl`` when each rank has its own card; ``gloo`` on the CPU
  and when several ranks share one card (NCCL refuses two ranks on one GPU).
  gloo carries CUDA tensors by staging them through the host; the gathers,
  scatter-adds and the model stay on the card. NCCL's collectives can be
  captured into a CUDA graph, gloo's cannot (:attr:`Mesh.capturable`), so a
  sharded ``fit`` replays its groups of K steps over NCCL only.

Every collective goes through a :class:`Mesh` method, which appends its
kind, group (``world``, ``data`` or ``model``), group size and bytes to
``Mesh.traffic``: all-to-alls, all-reduces and reduce-scatters by their
operand, all-gathers by their output, as
``tests/test_sharding.py::test_compiled_collective_bytes`` counts the
collectives of JAX's compiled step. It also adds what must leave this rank
to ``utils.cuda_graph.EXCHANGE_BYTES`` (``profiling.counters()["exchange_bytes"]``).
"""

from __future__ import annotations

import atexit
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import _tree
from ..device import DeviceLike, resolve_device
from ..utils import cuda_graph

DATA_AXIS = "data"
MODEL_AXIS = "model"
GRID_AXES = (DATA_AXIS, MODEL_AXIS)
Axes = Union[str, Tuple[str, ...]]

LAUNCH_HINT = (
    "start one process per rank and join them first: `torchrun --nproc_per_node N -m "
    "xsdeepfwfm_deprecated_torch.cli.main_all -mesh_data D -mesh_model M ...` (N = D*M), or "
    "xsdeepfwfm_deprecated_torch.parallel.launch.run_ranks; each rank calls "
    "parallel.mesh.init_distributed (backend gloo on the CPU or for ranks that share a card, "
    "nccl for one card a rank) and passes its own device")


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's place in the ``(data, model)`` mesh, its groups and its
    device. Made by :func:`make_mesh`, on every rank together."""

    def __init__(self, data: int, model: int, device: DeviceLike):
        self.data, self.model = data, model
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.device = torch.device(device)
        self.traffic: List[Tuple[str, str, int, int]] = []   # (kind, group, size, bytes)
        d_idx, m_idx = divmod(self.rank, model)
        self.data_group = self.model_group = None
        if data > 1:
            for m in range(model):
                group = dist.new_group([d * model + m for d in range(data)])
                if m == m_idx:
                    self.data_group = group
        if model > 1:
            for d in range(data):
                group = dist.new_group([d * model + m for m in range(model)])
                if d == d_idx:
                    self.model_group = group

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: NCCL's run
        on the card's streams, gloo's through the host."""
        return self.backend == "nccl"

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)], dtype=np.int64))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (the grid index is the rank)."""
        d, m = divmod(self.rank, self.model)
        return {GRID_AXES: self.rank, (DATA_AXIS,): d, (MODEL_AXIS,): m, (): 0}[_axes(axes)]

    def group(self, axes: Axes):
        """The process group of ``axes``; ``None`` is the world."""
        return {GRID_AXES: None, (DATA_AXIS,): self.data_group,
                (MODEL_AXIS,): self.model_group}[_axes(axes)]

    def _record(self, kind: str, axes: Axes, n_bytes: int) -> None:
        group = {GRID_AXES: "world", (DATA_AXIS,): "data", (MODEL_AXIS,): "model"}[_axes(axes)]
        n = self.axis_size(axes)
        self.traffic.append((kind, group, n, int(n_bytes)))
        # what must leave this rank: (n - 1) / n of the bytes recorded, twice for an all-reduce
        # (a reduce-scatter and an all-gather of its operand)
        cuda_graph.EXCHANGE_BYTES.add(int(n_bytes) * (n - 1) // n * (2 if kind == "all-reduce"
                                                                      else 1))

    def all_reduce(self, t: torch.Tensor, axes: Axes,
                   op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` in place over the ranks of ``axes``; returns ``t``."""
        n = self.axis_size(axes)
        if n > 1:
            self._record("all-reduce", axes, t.numel() * t.element_size())
            dist.all_reduce(t, op=op, group=self.group(axes))
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``(n, *t.shape)``: the ``t`` of every rank of ``axes``, in their index order."""
        n = self.axis_size(axes)
        if n == 1:
            return t.unsqueeze(0)
        out = t.new_empty((n * t.numel(),))     # one buffer, as a CUDA graph can hold it
        dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=self.group(axes))
        self._record("all-gather", axes, n * t.numel() * t.element_size())
        return out.view((n,) + tuple(t.shape))

    def reduce_scatter(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``t`` of shape ``(n, ...)`` summed over the ranks of ``axes``; each
        rank gets block ``j`` of the sum, ``j`` its index along ``axes``."""
        n = self.axis_size(axes)
        if n == 1:
            return t[0]
        out = t.new_empty(tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.reshape((-1,) + tuple(t.shape[2:])).contiguous(),
                                   group=self.group(axes))
        self._record("reduce-scatter", axes, t.numel() * t.element_size())
        return out

    def all_to_all(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Block ``j`` of ``t``'s first dimension goes to the rank of index ``j``
        along ``axes``; block ``j`` of the result came from it."""
        n = self.axis_size(axes)
        if n == 1:
            return t
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group(axes))
        self._record("all-to-all", axes, t.numel() * t.element_size())
        return out

    def barrier(self) -> None:
        """Every rank waits for the others (an all-reduce, so that it takes the
        mesh's device under either backend, then the device, which NCCL's
        all-reduce does not make the host wait for; not counted as traffic)."""
        dist.all_reduce(torch.zeros(1, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialized process group, for a
    rank on ``device`` (``None``: the card). ``data=None`` (or 0) takes all
    the ranks that ``model`` leaves. Raises a ``ValueError`` that says how to
    launch when there is no process group or it does not have ``data *
    model`` ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a data={data} x model={model} mesh needs a process group of "
                         f"ranks: {LAUNCH_HINT}")
    n = dist.get_world_size()
    if data is None or data <= 0:
        if n % model:
            raise ValueError(f"{n} ranks are not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} ranks, the "
                         f"process group has {n}: {LAUNCH_HINT}")
    return Mesh(data, model, resolve_device(device))


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join this process to the group of ranks (the counterpart of
    ``jax.distributed.initialize``, ``:46-55``). ``world_size`` and ``rank``
    default to torchrun's ``WORLD_SIZE`` and ``RANK``, ``init_method`` to
    ``env://``. A world of one process joins nothing, as in JAX. Returns
    whether a process group is initialized.

    A group made here is destroyed at the process's exit, as JAX registers
    its shutdown, unless the caller destroyed it before: a gloo group left
    to the interpreter's teardown can abort the process there ("terminate
    called without an active exception"). A process that runs one program
    after another keeps the group between them."""
    if dist.is_initialized():
        return True
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size <= 1:
        return False
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    atexit.register(_destroy_at_exit, dist.group.WORLD)
    return True


def _destroy_at_exit(group) -> None:
    """Destroy ``group`` if it is still the process's group."""
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


def local_rank_setup(device: DeviceLike = None) -> Tuple[torch.device, str]:
    """(device, backend) of this rank, from torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``. The card unless ``device`` is the CPU: card
    ``LOCAL_RANK`` and nccl when the host has a card for each of its ranks;
    otherwise the ranks share the cards round-robin over gloo. On the CPU,
    gloo."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo"
    dev = resolve_device(device)          # raises without a card
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    n_cards = torch.cuda.device_count()
    if device is None:
        dev = torch.device("cuda", local_rank % n_cards)
    return dev, ("nccl" if n_cards >= local_ranks else "gloo")


_TABLE_NAMES = ("emb1", "emb2", "ffm1", "ffm2")


def _is_dense_table_path(name: str) -> bool:
    """True for the dense-table leaf of any embedding group, in a parameter
    tree (``emb2/dense``) and in the optimizer-state trees that mirror it
    (``1/0/mu/emb2/dense``), so that the same helpers shard both. The QR
    tables (``emb2/q``, ``emb2/r``) are small and stay replicated."""
    parts = name.split("/")
    return parts[-1] == "dense" and any(p in _TABLE_NAMES for p in parts)


def _is_table(name: str, leaf: Any) -> bool:
    return _is_dense_table_path(name) and getattr(leaf, "ndim", 0) == 2


def param_shardings(tree: Any, table_axes: Axes) -> Dict[str, Optional[Axes]]:
    """Leaf name → the axes its rows are sharded over: ``table_axes`` for
    the dense packed tables (~97% of the flagship's parameters), ``None``
    (replicated) for everything else: R, the tower, the linear heads, the QR
    tables, Adam's count. Valid for optimizer-state trees too."""
    return {name: (table_axes if _is_table(name, leaf) else None)
            for name, leaf in _tree.named_leaves(tree)}


def pad_rows_for_mesh(tree: Any, shards: int) -> Any:
    """Pad the dense tables with zero rows to a multiple of ``shards``. The
    pad rows sit past every real index, which the lookups clip to their
    field, so they are never read."""
    if shards <= 1:
        return tree

    def pad(name, leaf):
        if _is_table(name, leaf) and leaf.shape[0] % shards:
            extra = shards - leaf.shape[0] % shards
            return torch.cat([leaf, leaf.new_zeros((extra,) + tuple(leaf.shape[1:]))])
        return leaf

    return _tree.tree_map_with_path(pad, tree)


def unpad_rows(tree: Any, dense_rows: int) -> Any:
    """Inverse of :func:`pad_rows_for_mesh`: every dense table (and its
    optimizer-moment mirrors) cut back to ``dense_rows`` real rows."""
    rows = max(dense_rows, 1)      # a spec without dense rows keeps one
    return _tree.tree_map_with_path(
        lambda name, leaf: leaf[:rows] if _is_table(name, leaf) and leaf.shape[0] > rows
        else leaf, tree)


def shard_params(tree: Any, mesh: Mesh, table_axes: Axes) -> Any:
    """This rank's tree: each dense table padded to the shard count and cut to
    the row block of this rank's index along ``table_axes``; every other leaf
    as it is. For parameters and optimizer state alike; key order kept."""
    n, i = mesh.axis_size(table_axes), mesh.axis_index(table_axes)
    if n == 1:
        return tree

    def cut(name, leaf):
        if not _is_table(name, leaf):
            return leaf
        rows = leaf.shape[0] // n
        return leaf[i * rows:(i + 1) * rows].clone()

    return _tree.tree_map_with_path(cut, pad_rows_for_mesh(tree, n))


def gather_params(tree: Any, mesh: Mesh, table_axes: Axes, dense_rows: int) -> Any:
    """Inverse of :func:`shard_params`: the full tree on every rank, each dense
    table gathered from its blocks and unpadded to ``dense_rows``."""
    if mesh.axis_size(table_axes) == 1:
        return tree
    rows = max(dense_rows, 1)
    return _tree.tree_map_with_path(
        lambda name, leaf: (mesh.all_gather(leaf, table_axes).reshape(-1, leaf.shape[1])[:rows]
                            if _is_table(name, leaf) else leaf), tree)


def batch_axes(a2a: bool) -> Axes:
    """The axes the batch is sharded over: both for the all-to-all exchanges
    (a DLRM-style model→data transition), ``data`` only for psum and for pure
    data parallelism, with indices replicated along ``model``."""
    return GRID_AXES if a2a else DATA_AXIS


def batch_rows(mesh: Mesh, axes: Axes, batch_size: int) -> slice:
    """This rank's rows of a global batch sharded over ``axes``."""
    b = batch_size // mesh.axis_size(axes)
    start = mesh.axis_index(axes) * b
    return slice(start, start + b)


def shard_batch(batch: Dict, mesh: Mesh, axes: Axes, batch_size: int) -> Dict:
    """This rank's rows of every per-row array of a global batch dict (``xi``,
    ``xv``, ``y``, ``mask``, ``teacher``); other entries pass through."""
    rows = batch_rows(mesh, axes, batch_size)
    return {k: (v[rows] if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == batch_size
                else v) for k, v in batch.items()}


class _SumOverRanks(torch.autograd.Function):
    """A SUM all-reduce whose backward is a SUM all-reduce of the cotangent
    over the same ranks: every rank's loss depends on every rank's summand,
    so the gradient of a summand gathers the cotangents of all of them. (The
    lookup exchange's identity backward is right for its own use only: there
    each rank's loss reads its own rows.)"""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(t.clone(), axes)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


@dataclass(frozen=True)
class BatchGroup:
    """The ranks that hold the rows of one global batch (``axes``: the world
    under the all-to-all exchanges, ``data`` under psum). What spans the whole
    batch, the distillation loss's softmax and QAT's activation scale, is
    reduced over them; each collective is recorded in ``Mesh.traffic``."""

    mesh: Mesh
    axes: Axes

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the ranks, outside the gradient (exact:
        the one-device maximum of the same rows, to the bit)."""
        return self.mesh.all_reduce(t.detach().clone(), self.axes, op=dist.ReduceOp.MAX)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, with a gradient (see
        :class:`_SumOverRanks`)."""
        return _SumOverRanks.apply(t, self.mesh, self.axes)


def reduce_gradients(mesh: Mesh, grads: Sequence[torch.Tensor],
                     shardings: Sequence[Optional[Axes]], batch: Axes) -> None:
    """Sum each gradient, in place, over the ranks that hold other rows of the
    batch for it: a replicated leaf over the batch's axes (the world for the
    all-to-all exchanges, the data group for psum); a row-sharded table over
    the batch axes its rows are not sharded over (the data group for a2a and
    psum, whose table blocks repeat along ``data``; nothing for a2a_grid,
    whose every row lives on one rank). One all-reduce for each group and
    dtype, over the gradients laid end to end. L2 joins after this, in the
    optimizer, so it is counted once."""
    buckets: Dict[Tuple[Tuple[str, ...], torch.dtype], List[torch.Tensor]] = {}
    for g, sh in zip(grads, shardings):
        if not isinstance(g, torch.Tensor):     # a bag table's, exchanged in its backward
            continue
        axes = tuple(a for a in _axes(batch) if sh is None or a not in _axes(sh))
        if mesh.axis_size(axes) > 1:
            buckets.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in buckets.items():
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in gs]), axes)
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))
