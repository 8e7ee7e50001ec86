"""The prune refresh's threshold search and zeroing: the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package's search (``compression/pruning._bisect``, kept as
the port's CPU path) is 40 halvings of a log-magnitude interval, each a pass over the
values. The kernel is in ``csrc/prune_search.cu``, whose header notes the bound on the
card and the design: an amax pass, then ``ROUNDS`` (5) counting rounds that each
resolve ``LEVELS`` (8) halvings at once from a 256-bin histogram, then one pass
that zeroes ``|w| < threshold`` in place, every searched group of the tree in each launch
and nothing read back to the host.

A group is a list of ``(leaf, counted)``: the first ``counted`` values of each leaf count
towards the group's one threshold (the embedding tables' real rows), and every value of
each leaf is zeroed below it. A leaf is float32 or bfloat16, read as float32.
:func:`search_reference` is the kernel's rounds in plain PyTorch, with the roundings of
``_bisect``, so that the two give its threshold to the bit, at the kernel's 8 halvings
a round or at another number that divides the 40. :func:`prune_search` launches the
kernel and takes CUDA tensors only: the CPU keeps ``_bisect``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ...device import exact_div
from . import _build

ITERS = 40             # halvings of the search: compression.pruning.BISECT_ITERS
LEVELS = 8             # halvings a counting round resolves: 2^8 bins
ROUNDS = ITERS // LEVELS
LAUNCHES = ROUNDS + 2  # a search's launches: the amax pass, the rounds, the zeroing
MAX_SEGMENTS = 32      # leaves whose pointers fit the kernel's parameter block: one search
DTYPES = (torch.float32, torch.bfloat16)   # the storage types the kernel takes
LO_SPAN = -120.0 * 0.6931472               # lo = hi + LO_SPAN: the interval's floor, amax * 2^-120
AMAX_FLOOR = 1e-30

Group = Sequence[Tuple[torch.Tensor, int]]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"prune_search: {msg}")


def check_groups(groups: Sequence[Group], targets: Sequence[torch.Tensor]) -> None:
    """Every check a search needs; raises ``ValueError`` on what the kernel does
    not take. Plain Python over shapes, types and strides; it touches no device.
    The device comes last, so every other refusal shows on CPU tensors too."""
    _check(len(groups) > 0, "takes at least one group")
    _check(len(targets) == len(groups), f"{len(groups)} groups but {len(targets)} targets")
    device = groups[0][0][0].device if groups[0] else None
    for g, group in enumerate(groups):
        _check(len(group) > 0, f"group {g} is empty")
        _check(len(group) <= MAX_SEGMENTS, f"group {g} has more than {MAX_SEGMENTS} leaves")
        for leaf, counted in group:
            _check(leaf.dtype in DTYPES, f"a leaf of group {g} is {leaf.dtype}, not float32 "
                                         "or bfloat16")
            _check(leaf.device == device, f"a leaf of group {g} is not on {device}")
            _check(leaf.is_contiguous(), f"a leaf of group {g} is not contiguous")
            _check(0 <= counted <= leaf.numel(),
                   f"a leaf of group {g} counts {counted} of its {leaf.numel()} values")
        _check(sum(counted for _, counted in group) > 0, f"group {g} counts no value")
        _check(targets[g].numel() == 1 and targets[g].device == device,
               f"group {g}'s target is not one value on {device}")
    _check(device.type == "cuda", f"takes CUDA tensors, not {device}")


def _midpoints(lo: torch.Tensor, hi: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """The 2^levels - 1 midpoints of the next ``levels`` halvings of [lo, hi] in heap
    order (node i's children are 2i and 2i+1, the lower half first), each a 0-d
    tensor made as ``_bisect`` makes its midpoint."""
    nodes, spans = [], [(lo, hi)]
    for _ in range(levels):
        below = []
        for lo_i, hi_i in spans:
            mid = 0.5 * (lo_i + hi_i)
            nodes.append(mid)
            below += [(lo_i, mid), (mid, hi_i)]
        spans = below
    return nodes


@torch.no_grad()
def search_reference(groups: Sequence[Group], targets: Sequence[torch.Tensor], *,
                     levels: int = LEVELS) -> torch.Tensor:
    """The kernel's search in plain PyTorch: each group's threshold, as a float32
    tensor of one value a group on the groups' device; the leaves are not changed.
    Each of the ``ITERS // levels`` rounds builds the midpoints of the next
    ``levels`` halvings, takes their ``exp`` one 0-d tensor at a time (the CPU's
    vectorized exp may round otherwise), walks every value down that tree to its
    bin, and replays the halvings from the bins' counts."""
    _check(levels >= 1 and ITERS % levels == 0, f"{levels} levels a round do not divide {ITERS}")
    out = []
    for group, target in zip(groups, targets):
        x = torch.cat([leaf.reshape(-1)[:counted].to(torch.float32)
                       for leaf, counted in group]).abs()
        n = x.numel()
        t = target.reshape(()).to(torch.float32).clamp(0.0, 1.0)
        hi = x.max().clamp(min=AMAX_FLOOR).log()
        lo = hi + LO_SPAN
        for _ in range(ITERS // levels):
            tree = torch.stack([mid.exp() for mid in _midpoints(lo, hi, levels)])
            node = torch.ones(n, dtype=torch.long, device=x.device)
            for _ in range(levels):
                node = 2 * node + (~(x < tree[node - 1])).long()
            below = torch.bincount(node - (1 << levels), minlength=1 << levels).cumsum(0)
            node = torch.ones((), dtype=torch.long, device=x.device)
            for d in range(levels):
                rank = ((2 * (node - (1 << d)) + 1) << (levels - 1 - d)) - 1
                mid = 0.5 * (lo + hi)
                go_up = exact_div(below[rank].to(torch.float32), float(n)) < t
                lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
                node = 2 * node + go_up.long()
        thr = (0.5 * (lo + hi)).exp()
        out.append(torch.where(t > 0.0, thr, torch.zeros_like(thr)))
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("prune_search")
    ptr, ptrs, i32, i64s, i32s = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_int))
    lib.prune_search.argtypes = [i32, ptrs, i64s, i64s, i32s, i32s, i32, ptr, ptr, ptr]
    lib.prune_search.restype = i32
    lib.prune_search_group_bytes.restype = i32
    lib.prune_search_math.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ptr]
    lib.prune_search_math.restype = i32
    return lib


def _batches(groups: Sequence[Group]) -> List[List[int]]:
    """The groups' indices cut into launches of at most ``MAX_SEGMENTS`` leaves."""
    out, size = [[]], 0
    for g, group in enumerate(groups):
        if size + len(group) > MAX_SEGMENTS:
            out.append([])
            size = 0
        out[-1].append(g)
        size += len(group)
    return out


@_build.counted     # kernel launches on the card: LAUNCHES a search
@torch.no_grad()
def prune_search(groups: Sequence[Group], targets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each group's magnitude threshold below which its ``target`` share of the
    counted values fall (the 40 halvings of ``compression.pruning._bisect``; 0
    where the target is 0), and ``|w| < threshold`` zeroed in place in every leaf
    of the group, on the card. Returns the thresholds, a float32 tensor of one
    value a group. ``LAUNCHES`` launches for each ``MAX_SEGMENTS`` leaves, or a
    ``ValueError`` before any."""
    check_groups(groups, targets)
    device = groups[0][0][0].device
    target = torch.stack([t.reshape(()).to(torch.float32) for t in targets]).clamp(0.0, 1.0)
    lib = _lib()
    words = lib.prune_search_group_bytes() // 4
    work = torch.zeros((len(groups), words), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for batch in _batches(groups):
            segs = [(leaf, counted, i) for i, g in enumerate(batch) for leaf, counted in groups[g]]
            n = len(segs)
            rc = lib.prune_search(
                n, (ctypes.c_void_p * n)(*(leaf.data_ptr() for leaf, _, _ in segs)),
                (ctypes.c_longlong * n)(*(counted for _, counted, _ in segs)),
                (ctypes.c_longlong * n)(*(leaf.numel() for leaf, _, _ in segs)),
                (ctypes.c_int * n)(*(i for _, _, i in segs)),
                (ctypes.c_int * n)(*(int(leaf.dtype == torch.bfloat16) for leaf, _, _ in segs)),
                len(batch), target[batch[0]:].data_ptr(), work[batch[0]:].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"prune_search: CUDA error {rc} at launch")
            prune_search.launches += LAUNCHES
    return work.view(torch.float32)[:, 3]    # GroupState.thr


def kernel_math(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expf`` and ``logf`` of a float32 CUDA tensor as the kernel computes them
    (for the tests, which hold them to torch's ``exp`` and ``log``)."""
    _check(x.dtype == torch.float32 and x.is_cuda and x.is_contiguous() and x.numel() > 0,
           "kernel_math takes a non-empty contiguous float32 CUDA tensor")
    exp_out, log_out = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().prune_search_math(x.data_ptr(), exp_out.data_ptr(), log_out.data_ptr(),
                                      x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prune_search: CUDA error {rc} at launch")
    return exp_out, log_out
