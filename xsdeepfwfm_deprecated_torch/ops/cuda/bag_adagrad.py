"""DLRM-DCNv2's sparse Adagrad on the batch's distinct rows: the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package has no multi-hot bags. The kernel is in
``csrc/bag_adagrad.cu``, whose header notes the bound on the card (each bag's gradient,
each id, and each distinct row's weights and accumulator read and written once: 2.87 GB at
the benchmark's DLRM-DCNv2 cell) and the design: the ids sorted stably as int32 keys with
their positions, then one warp a slice of ``SLICE`` sorted ids that sums each distinct
row's gradients in registers in position order and steps the row once; a segment that runs
past its slice leaves a partial sum a slice, which a second launch adds in order. No float
atomics and no (N, E) buffer, so two runs on one batch are equal to the bit.

:func:`bag_adagrad_reference` is the kernel's order in plain PyTorch (each segment cut at
the multiples of ``SLICE`` of the sorted order, each piece summed from 0 in position order,
the pieces added in order), with the roundings of ``ops/embedding.bag_adagrad_torch``'s
step, so that the two agree bit for bit on the card. :func:`bag_adagrad` launches the kernel
and takes CUDA tensors only: ``ops/embedding.bag_adagrad_`` calls it on the card and keeps
``bag_adagrad_torch`` on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ...device import constant
from . import _build

SLICE = 32              # sorted ids a warp of the first launch walks (csrc/bag_adagrad.cu)
LAUNCHES = 2            # a step's launches: the slices, then the joins
MAX_WIDTH = 128         # E: 32 lanes x one 16-B vector a row
MAX_COLUMNS = 256       # ids a row of the batch, each column's field held in a byte
INDEX_LIMIT = 2 ** 31   # rows of the table and ids of the batch: int32 keys and positions


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"bag_adagrad: {msg}")


def check_bags(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor, grad: torch.Tensor,
               column_field: Sequence[int], count: torch.Tensor) -> None:
    """Every check a step needs; raises ``ValueError`` on what the kernel does not
    take. Plain Python over shapes, types and strides; it touches no device. The
    device comes last, so every other refusal shows on CPU tensors too."""
    for name, t in (("the table", table), ("the accumulator", acc), ("the gradient", grad)):
        _check(t.dtype == torch.float32, f"{name} is {t.dtype}, not float32")
    _check(table.dim() == 2 and acc.shape == table.shape,
           f"the table {tuple(table.shape)} and its accumulator {tuple(acc.shape)} differ")
    width = table.shape[1]
    _check(width % 4 == 0 and 4 <= width <= MAX_WIDTH,
           f"width {width}: the kernel takes a multiple of 4 up to {MAX_WIDTH}")
    _check(table.shape[0] < INDEX_LIMIT, f"{table.shape[0]} rows: the kernel keys rows in int32")
    _check(rows.dim() == 2 and rows.dtype in (torch.int32, torch.int64),
           f"the ids are {rows.dtype} {tuple(rows.shape)}, not (B, columns) int32 or int64")
    columns = len(column_field)
    _check(rows.shape[1] == columns and 1 <= columns <= MAX_COLUMNS,
           f"{rows.shape[1]} columns of ids for a map of {columns}, not 1 to {MAX_COLUMNS}")
    _check(grad.dim() == 3 and grad.shape[0] == rows.shape[0] and grad.shape[2] == width,
           f"the gradient {tuple(grad.shape)} is not ({rows.shape[0]}, fields, {width})")
    _check(all(0 <= f < grad.shape[1] for f in column_field),
           f"a column's field is not one of the gradient's {grad.shape[1]}")
    _check(rows.numel() < INDEX_LIMIT, f"{rows.numel()} ids: the kernel keys positions in int32")
    for name, t in (("the table", table), ("the accumulator", acc), ("the ids", rows)):
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(grad.stride(2) == 1 and grad.stride(0) % 4 == 0 and grad.stride(1) % 4 == 0,
           f"the gradient's strides {grad.stride()} are not (4k, 4k, 1)")
    _check(count.dtype == torch.int64 and count.numel() == 1, "count is not one int64")
    device = table.device
    _check(all(t.device == device for t in (acc, rows, grad, count)),
           f"the operands are not all on {device}")
    _check(device.type == "cuda", f"takes CUDA tensors, not {device}")
    _check(all(t.data_ptr() % 16 == 0 for t in (table, acc, grad)),
           "the table, accumulator and gradient must start on 16 bytes")


def segment_sums(keys: torch.Tensor, pos: torch.Tensor, grad: torch.Tensor,
                 column_field: Sequence[int], *,
                 slice_ids: int = SLICE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, sums): each distinct key of the sorted ``keys`` and the sum of the
    gradients of the bags its ids read, in the kernel's order: the sorted slots are
    cut at every segment head and every multiple of ``slice_ids``, each piece is
    summed from 0 in slot order, and a segment's pieces are added from 0 in order.
    ``pos`` is each sorted id's position b * columns + c."""
    n = keys.numel()
    _, fields, width = grad.shape
    columns = len(column_field)
    field_of = constant(tuple(column_field), torch.long, keys.device)
    pos = pos.long()
    g = grad.reshape(-1, width).index_select(0, (pos // columns) * fields
                                             + field_of[pos % columns])
    at = torch.arange(n, device=keys.device)
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    cut = head | (at % slice_ids == 0)
    piece = torch.cumsum(cut, 0) - 1                    # slot -> its piece
    starts = at[cut]                                    # each piece's first slot
    place = at - starts[piece]                          # a slot's place in its piece
    parts = g.new_zeros((starts.numel(), width))
    for j in range(min(slice_ids, n)):                  # one slot of every piece a pass
        sel = place == j
        parts.index_add_(0, piece[sel], g[sel])
    seg = torch.cumsum(head, 0) - 1
    piece_seg = seg[starts]                             # each piece's segment
    rank = torch.arange(starts.numel(), device=keys.device) - torch.nonzero(
        head[starts]).flatten()[piece_seg]              # a piece's place in its segment
    sums = g.new_zeros((int(head.sum()), width))
    for r in range(int(rank.max()) + 1 if n else 0):    # one piece of every segment a pass
        sel = rank == r
        sums.index_add_(0, piece_seg[sel], parts[sel])
    return keys[head], sums


@torch.no_grad()
def bag_adagrad_reference(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor,
                          grad: torch.Tensor, column_field: Sequence[int], lr: float,
                          eps: float, count: torch.Tensor, *, slice_ids: int = SLICE,
                          skip: Optional[int] = None) -> None:
    """The kernel's step in plain PyTorch, in place on ``table``, ``acc`` and
    ``count``: :func:`segment_sums` over the stably sorted ids, then the step of
    ``ops/embedding.bag_adagrad_torch`` on each distinct row once. Rows from
    ``skip`` up are left, as the kernel leaves them: their ids sort last, so the
    pieces of the ids before them are the same without them, and they are cut
    before the sums."""
    keys, pos = torch.sort(rows.reshape(-1), stable=True)
    if skip is not None:
        live = int((keys < skip).sum())
        keys, pos = keys[:live], pos[:live]
    rows_, g = segment_sums(keys, pos, grad, column_field, slice_ids=slice_ids)
    a = acc.index_select(0, rows_).add_(g * g)
    acc.index_copy_(0, rows_, a)
    live = a > 0
    upd = a.add_(eps).rsqrt_().mul_(g).masked_fill_(~live, 0.0)
    table.index_add_(0, rows_, upd, alpha=-lr)
    count.add_(rows_.numel())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bag_adagrad")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.bag_adagrad_step.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i64,
                                     i64, ctypes.POINTER(ctypes.c_ubyte), i32, ctypes.c_float,
                                     ctypes.c_float, ptr]
    lib.bag_adagrad_step.restype = i32
    lib.bag_adagrad_slice_ids.restype = i32
    if lib.bag_adagrad_slice_ids() != SLICE:
        raise RuntimeError(f"csrc/bag_adagrad.cu takes {lib.bag_adagrad_slice_ids()} ids a "
                           f"slice, its wrapper {SLICE}")
    return lib


@_build.counted     # kernel launches on the card: LAUNCHES a step
@torch.no_grad()
def bag_adagrad(table: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor, grad: torch.Tensor,
                column_field: Sequence[int], lr: float, eps: float,
                count: torch.Tensor, skip: Optional[int] = None) -> None:
    """Adagrad on the rows that ``rows`` (B, columns) name, in place on ``table``
    and ``acc``, each distinct row's gradient the sum of its ids' bag gradients
    ``grad`` (B, fields, E), E contiguous (column c reads field ``column_field[c]``:
    the backward's gradient of the pooled bags is a view into x₀'s); ``count``
    gains the number of distinct rows. Rows from ``skip`` up (a sharded step's
    rows held elsewhere) are left and not counted. ``LAUNCHES`` launches after a
    stable sort, or a ``ValueError`` before any."""
    check_bags(table, acc, rows, grad, column_field, count)
    _check(skip is None or 0 <= skip <= table.shape[0],
           f"skip {skip} is not a row of the {table.shape[0]}")
    n = rows.numel()
    keys, pos = torch.sort(rows.reshape(-1).to(torch.int32), stable=True)
    partial = torch.empty((-(-n // SLICE), table.shape[1]), dtype=torch.float32,
                          device=table.device)
    columns = len(column_field)
    with torch.cuda.device(table.device):
        rc = _lib().bag_adagrad_step(
            table.data_ptr(), acc.data_ptr(), grad.data_ptr(), keys.data_ptr(), pos.data_ptr(),
            partial.data_ptr(), count.data_ptr(), n, columns, grad.shape[1], table.shape[1],
            grad.stride(0), grad.stride(1), (ctypes.c_ubyte * columns)(*column_field),
            -1 if skip is None else skip, eps, -lr,
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bag_adagrad: CUDA error {rc} at launch")
    if n:
        bag_adagrad.launches += LAUNCHES
