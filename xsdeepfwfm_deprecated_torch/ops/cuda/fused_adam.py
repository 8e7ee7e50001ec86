"""Adam with L2 over a whole leaf list in one pass: the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package leaves its optimizer (optax) to XLA,
which fuses it. The kernel is in ``csrc/fused_adam.cu``, whose header notes
the bound on the card (28 B a value: 0.261 ms at the Avazu model's leaves,
0.115 ms at the Criteo flagship's) and the design. One launch updates
every leaf, in place:

* g = grad + wd * p (where wd is not 0);
* mu = b1 * mu + (1 - b1) * g, then mu = 0 where |mu| < ``FLT_MIN`` on the
  leaves flagged in ``flush``: XLA (and the TPU) flush subnormal results,
  PyTorch keeps them (``train.trainer.Optimizer.update`` says which leaves
  and why);
* nu = b2 * nu + (1 - b2) * g * g;
* p = p - lr * (mu / bc1) / (sqrt(nu / bc2) + eps).

A leaf is float32 or bfloat16 (``-table_dtype bf16`` stores the tables, their
gradients and their moments in bfloat16); the four arrays of a leaf share
its type. :func:`adam_reference` is the same step as PyTorch's ``_foreach``
passes (the optimizer's update before the kernel, unchanged); the kernel
rounds each operation as those passes do on the card, in either type, so
the two agree bit for bit. :func:`fused_adam` launches the kernel for CUDA
tensors, once for each ``MAX_LEAVES`` leaves, and runs the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

MAX_LEAVES = 32   # leaves whose pointers fit the kernel's parameter block: one launch
DTYPES = (torch.float32, torch.bfloat16)   # the storage types the kernel takes

Leaves = Sequence[torch.Tensor]


def adam_reference(p: Leaves, grads: Leaves, mu: Leaves, nu: Leaves, flush: Sequence[bool],
                   bc1: torch.Tensor, bc2: torch.Tensor, *, lr: float, wd: float, b1: float,
                   b2: float, eps: float) -> None:
    """The kernel's step in plain PyTorch, in place on ``p``, ``mu`` and
    ``nu``. ``bc1`` and ``bc2`` are the bias corrections 1 - b^count."""
    g = torch._foreach_add(grads, p, alpha=wd) if wd else list(grads)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1 - b1)
    for m in [m for m, f in zip(mu, flush) if f]:
        m.masked_fill_(m.abs() < torch.finfo(m.dtype).tiny, 0)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - b2)
    upd = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(p, upd, alpha=-lr)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_adam")
    ptr, ptrs, f32, i32 = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_float,
                           ctypes.c_int)
    lib.fused_adam_step.argtypes = [
        i32, ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i32),
        ctypes.POINTER(i32), ptr, ptr, f32, f32, f32, f32, f32, f32, f32, i32, ptr]
    lib.fused_adam_step.restype = i32
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_adam: {msg}")


def check_leaves(p: Leaves, grads: Leaves, mu: Leaves, nu: Leaves, flush: Sequence[bool],
                 bc1: torch.Tensor, bc2: torch.Tensor) -> None:
    """Every check one launch needs; raises ``ValueError`` on what the kernel
    does not take. Plain Python over shapes, types and strides; it touches
    no device."""
    n = len(p)
    _check(0 < n <= MAX_LEAVES, f"takes 1 to {MAX_LEAVES} leaves a launch, got {n}")
    _check(len(grads) == len(mu) == len(nu) == len(flush) == n,
           "p, grads, mu, nu and flush must have one entry a leaf")
    device = p[0].device
    for i, group in enumerate(zip(p, grads, mu, nu)):
        _check(all(t.dtype in DTYPES for t in group),
               f"leaf {i} has an array that is not float32 or bfloat16")
        _check(all(t.dtype == group[0].dtype for t in group),
               f"leaf {i}'s p, grad, mu and nu differ in dtype")
        _check(all(t.is_contiguous() for t in group), f"leaf {i} is not contiguous")
        _check(all(t.device == device for t in group), f"leaf {i} is not on {device}")
        _check(all(t.shape == group[0].shape for t in group),
               f"leaf {i}'s p, grad, mu and nu differ in shape")
    _check(all(t.dtype == torch.float32 and t.numel() == 1 and t.device == device
               for t in (bc1, bc2)), f"bc1 and bc2 must be one float32 value each on {device}")


@_build.counted     # kernel launches on the card: one a step up to MAX_LEAVES leaves
def fused_adam(p: Leaves, grads: Leaves, mu: Leaves, nu: Leaves, flush: Sequence[bool],
               bc1: torch.Tensor, bc2: torch.Tensor, *, lr: float, wd: float, b1: float,
               b2: float, eps: float) -> None:
    """One Adam step with L2 over every leaf, in place on ``p``, ``mu`` and
    ``nu``; ``flush[i]`` zeroes leaf i's subnormal first moments. CUDA
    tensors launch the kernel once for each ``MAX_LEAVES`` leaves (or
    raise, before any launch); CPU tensors run :func:`adam_reference`."""
    if p and p[0].device.type == "cpu":
        adam_reference(p, grads, mu, nu, flush, bc1, bc2, lr=lr, wd=wd, b1=b1, b2=b2, eps=eps)
        return
    _check(bool(p) and p[0].device.type == "cuda",
           f"unsupported device {p[0].device if p else None}")
    _check(len(grads) == len(mu) == len(nu) == len(flush) == len(p),
           "p, grads, mu, nu and flush must have one entry a leaf")
    groups = [slice(s, s + MAX_LEAVES) for s in range(0, len(p), MAX_LEAVES)]
    for g in groups:
        check_leaves(p[g], grads[g], mu[g], nu[g], flush[g], bc1, bc2)
    lib = _lib()
    # Python floats to float32 as PyTorch turns a foreach op's scalar into its opmath type
    scalars = (b1, 1 - b1, b2, 1 - b2, eps, -lr, wd)
    with torch.cuda.device(p[0].device):
        stream = torch.cuda.current_stream(p[0].device).cuda_stream
        for g in groups:
            leaves = p[g]
            n = len(leaves)

            def addresses(ts):
                return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

            def flags(values):
                return (ctypes.c_int * n)(*(int(bool(v)) for v in values))

            rc = lib.fused_adam_step(n, addresses(leaves), addresses(grads[g]), addresses(mu[g]),
                                     addresses(nu[g]),
                                     (ctypes.c_longlong * n)(*(t.numel() for t in leaves)),
                                     flags(flush[g]),
                                     flags(t.dtype == torch.bfloat16 for t in leaves),
                                     bc1.data_ptr(), bc2.data_ptr(), *scalars, int(bool(wd)),
                                     stream)
            if rc != 0:
                raise RuntimeError(f"fused_adam: CUDA error {rc} at launch")
            fused_adam.launches += 1
