"""One layer of xDeepFM's CIN, forward and backward: the CUDA kernels and their plain version.

Replaces no TPU kernel: the JAX package has no CIN. The kernels are in ``csrc/cin.cu``,
whose header notes the bound on the card (the FFMA rate: 2 FLOP a term of
``X^k[r, h] = Σ_{i,j} W_k[h, i·m+j] · X^{k-1}[r, i] · X⁰[r, j]``, in each direction) and
the design: the outer product ``z = X^{k-1} ⊗ X⁰`` and its gradient are built a tile at a
time in shared memory and never written to device memory.

Activations are feature-major here: ``X^kᵀ`` is (H_k, M) and ``X⁰ᵀ`` is (m, M) over the
rows r = (b, d), M = B·D, so that each kernel reads and writes along r. ``W_k`` keeps its
(H_k, H_{k-1}·m) layout, column i·m + j; :func:`pack_forward` and :func:`pack_grad_x`
copy it into the tiles the kernels stream.

:class:`CinLayer` is the layer as a ``torch.autograd.Function`` (X^{k-1}ᵀ, X⁰ᵀ, W_k) →
X^kᵀ; it saves its three inputs, never z. On CPU tensors it runs
:func:`cin_layer_reference` and :func:`cin_layer_grads_reference`, the materialized
form, whose backward repeats the kernels' contraction; on the card it launches the
kernels. :func:`cin` checks its operands, then applies the layer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

ROWS = 80            # the kernels' tile: 80 rows r (csrc/cin.cu BM)
COLS = 200           # by 200 columns: maps h, or whole field groups i·m + j (BN)
DEPTH = 20           # over k-tiles of 20 (BK)
MAX_FIELDS = COLS    # m: the dX kernel takes floor(COLS / m) whole fields a chunk
MAX_TERMS = 1 << 22  # H_{k-1}·m: the kernels split a column into (i, j) by a float product
SLICE_WAVES = 3      # dW's split over the rows: about this many waves of 2 blocks an SM
MIN_SLICE_TILES = 8  # k-tiles a slice at least
MAX_SLICES = 64


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"cin: {msg}")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def check_layer(xk1t: torch.Tensor, x0t: torch.Tensor, w: torch.Tensor) -> None:
    """Every check a layer needs; raises ``ValueError`` on what the kernels do not
    take. Plain Python over shapes, types and strides; it touches no device."""
    for name, t in (("X^{k-1}", xk1t), ("X0", x0t), ("W_k", w)):
        _check(t.dim() == 2, f"{name} is not 2-d: {tuple(t.shape)}")
        _check(t.dtype == torch.float32, f"{name} is {t.dtype}, not float32")
        _check(t.is_contiguous(), f"{name} is not contiguous")
        _check(t.device == xk1t.device, f"{name} is on {t.device}, not {xk1t.device}")
    (hp, rows), (m, rows0) = xk1t.shape, x0t.shape
    _check(rows == rows0, f"X^{{k-1}} has {rows} rows and X0 {rows0}")
    _check(1 <= m <= MAX_FIELDS, f"{m} fields, not 1 to {MAX_FIELDS}")
    _check(hp >= 1 and hp * m <= MAX_TERMS, f"H_{{k-1}}·m = {hp}·{m} is not 1 to {MAX_TERMS}")
    _check(w.shape[0] >= 1 and w.shape[1] == hp * m,
           f"W_k is {tuple(w.shape)}, not (H_k, {hp}·{m})")
    _check(max(hp, m) * rows < 2 ** 31, f"{max(hp, m)}·{rows} values a tensor: the kernels "
                                        "index X^{k-1} and X0 in 32 bits")


def cin_layer_reference(xk1t: torch.Tensor, x0t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^kᵀ (H_k, M) = W_k · zᵀ with the (H_{k-1}·m, M) outer product materialized."""
    z = (xk1t.unsqueeze(1) * x0t.unsqueeze(0)).reshape(-1, xk1t.shape[1])
    return w @ z


def cin_layer_grads_reference(g: torch.Tensor, xk1t: torch.Tensor, x0t: torch.Tensor,
                              w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dX^{k-1}ᵀ, dX⁰ᵀ, dW_k) from G = dX^kᵀ, materialized as the kernels contract it:
    dW_k = G · z, and dZ = W_kᵀ · G contracted with X⁰ over j and with X^{k-1} over i."""
    hp, rows = xk1t.shape
    m = x0t.shape[0]
    z = (xk1t.unsqueeze(1) * x0t.unsqueeze(0)).reshape(-1, rows)
    dz = (w.T @ g).view(hp, m, rows)
    return (dz * x0t.unsqueeze(0)).sum(dim=1), (dz * xk1t.unsqueeze(1)).sum(dim=0), g @ z.T


def pack_forward(w: torch.Tensor) -> torch.Tensor:
    """W_k as the forward kernel streams it: (⌈H_k/COLS⌉, ⌈K/DEPTH⌉, DEPTH, COLS),
    ``[n][t][k][c] = W_k[n·COLS + c, t·DEPTH + k]``, 0 past the edges (K = H_{k-1}·m)."""
    h, k = w.shape
    nt, kt = _ceil(h, COLS), _ceil(k, DEPTH)
    wp = F.pad(w, (0, kt * DEPTH - k, 0, nt * COLS - h))
    return wp.view(nt, COLS, kt, DEPTH).permute(0, 2, 3, 1).contiguous()


def fields_a_chunk(m: int) -> int:
    """Whole fields (values of i) in one of the dX kernel's column chunks."""
    return COLS // m


def pack_grad_x(w: torch.Tensor, m: int) -> torch.Tensor:
    """W_k as the dX kernel streams it: (chunks, ⌈H_k/DEPTH⌉, DEPTH, COLS),
    ``[c][t][k][n] = W_k[t·DEPTH + k, c·g·m + n]`` for n < g·m, 0 elsewhere and past
    the edges, where g = :func:`fields_a_chunk` and chunks = ⌈H_{k-1}/g⌉."""
    h, k = w.shape
    g = fields_a_chunk(m)
    chunks, kt = _ceil(k // m, g), _ceil(h, DEPTH)
    wp = F.pad(w, (0, chunks * g * m - k, 0, kt * DEPTH - h)).view(kt, DEPTH, chunks, g * m)
    return F.pad(wp, (0, COLS - g * m)).permute(2, 0, 1, 3).contiguous()


def slices(tiles: int, rows: int, sms: int) -> Tuple[int, int]:
    """dW's split over the rows: (slices, rows a slice), so that ``tiles`` output
    tiles times the slices make about ``SLICE_WAVES`` waves of two blocks an SM, each
    slice at least ``MIN_SLICE_TILES`` k-tiles deep. Every slice holds rows."""
    want = max(1, min(MAX_SLICES, SLICE_WAVES * 2 * sms // tiles,
                      rows // (MIN_SLICE_TILES * DEPTH)))
    per = max(1, _ceil(_ceil(rows, want), DEPTH)) * DEPTH
    return max(1, _ceil(rows, per)), per


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cin")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cin_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.cin_grad_w.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.cin_grad_x.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    for fn in (lib.cin_forward, lib.cin_grad_w, lib.cin_grad_x):
        fn.restype = i32
    got = (lib.cin_tile_rows(), lib.cin_tile_cols(), lib.cin_tile_depth(), lib.cin_max_fields())
    if got != (ROWS, COLS, DEPTH, MAX_FIELDS):
        raise RuntimeError(f"csrc/cin.cu's tile {got} is not ops/cuda/cin.py's")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cin: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(xk1t: torch.Tensor, x0t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    (hp, rows), m, h = xk1t.shape, x0t.shape[0], w.shape[0]
    wf = pack_forward(w)
    out = torch.empty((h, rows), dtype=torch.float32, device=xk1t.device)
    with torch.cuda.device(xk1t.device):
        _launch(_lib().cin_forward, xk1t.data_ptr(), x0t.data_ptr(), wf.data_ptr(),
                out.data_ptr(), hp, m, h, rows, _stream(xk1t))
    cin.launches += 1 if rows else 0
    return out


def _grads(g: torch.Tensor, xk1t: torch.Tensor, x0t: torch.Tensor,
           w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    (hp, rows), m, h = xk1t.shape, x0t.shape[0], w.shape[0]
    dev = xk1t.device
    n_slices, per = slices(_ceil(hp * m, ROWS) * _ceil(h, COLS), rows, _sms(dev.index or 0))
    g_rows = g.T.contiguous()                                    # G as (M, H_k) for dW
    partial = torch.empty((n_slices if n_slices > 1 else 0, h, hp * m), dtype=torch.float32,
                          device=dev)
    dw = torch.empty_like(w)
    wx = pack_grad_x(w, m)
    dxk1t, dx0t = torch.empty_like(xk1t), torch.empty_like(x0t)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _stream(xk1t)
        _launch(lib.cin_grad_w, xk1t.data_ptr(), x0t.data_ptr(), g_rows.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), hp, m, h, rows, n_slices, per, stream)
        _launch(lib.cin_grad_x, g.data_ptr(), wx.data_ptr(), xk1t.data_ptr(), x0t.data_ptr(),
                dxk1t.data_ptr(), dx0t.data_ptr(), hp, m, h, rows, stream)
    cin.launches += (3 if n_slices > 1 else 2) if rows else 0
    return dxk1t, dx0t, dw


class CinLayer(torch.autograd.Function):
    """(X^{k-1}ᵀ, X⁰ᵀ, W_k) → X^kᵀ; the kernels on the card, the plain version on the
    CPU. Layer 1 passes X⁰ᵀ twice, and autograd adds its two gradients."""

    @staticmethod
    def forward(ctx, xk1t, x0t, w):
        ctx.save_for_backward(xk1t, x0t, w)
        if xk1t.device.type == "cpu":
            return cin_layer_reference(xk1t, x0t, w)
        return _forward(xk1t, x0t, w)

    @staticmethod
    def backward(ctx, g):
        xk1t, x0t, w = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            return cin_layer_grads_reference(g, xk1t, x0t, w)
        return _grads(g, xk1t, x0t, w)


@_build.counted     # kernel launches on the card: 1 a layer forward, 2 or 3 backward
def cin(xk1t: torch.Tensor, x0t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer, X^kᵀ (H_k, M) from X^{k-1}ᵀ (H_{k-1}, M), X⁰ᵀ (m, M) and W_k
    (H_k, H_{k-1}·m), differentiable in all three. CUDA tensors launch the kernels
    (or raise, before any launch); CPU tensors run the plain version."""
    check_layer(xk1t, x0t, w)
    _check(xk1t.device.type in ("cpu", "cuda"), f"unsupported device {xk1t.device}")
    return CinLayer.apply(xk1t, x0t, w)
