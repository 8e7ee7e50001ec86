"""Int8 quantization primitives: symmetric per-tensor / per-channel / per-row
quantization and exact int8 matrix products.

Port of ``xsdeepfwfm_deprecated_tpu/ops/quantized.py:20-121``. Rounding is
half-to-even (``torch.round``, as ``jnp.round``) and codes clip to
[-127, 127]. ``fake_quant`` comes with the QAT slice.

PyTorch has no int32 ``matmul`` on CUDA, and ``torch._int_mm`` needs K to be
a multiple of 8 (the tower's first layer has K = 390). So
:func:`exact_int_matmul` forms the int32 accumulators as float32 matmuls of
integer-valued tensors: every product and every partial sum is an integer
of magnitude at most ``127² · K``, which float32 holds exactly while it is
below 2²⁴, i.e. for K ≤ 1040. Longer K is cut into chunks of 1040 whose
exact results are summed in int32. A model keeps the float32 copy of each
weight's codes beside the codes (:func:`float_codes`, made once on the
model's device), so a call converts only the activations.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import exact_div

EXACT_K = (1 << 24) // (127 * 127)   # 1040: the longest exact float32 chunk


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return exact_div(amax.clamp(min=1e-12), 127.0)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def quantize_symmetric(x: torch.Tensor, axis: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ≈ q·scale with q ∈ int8 [-127, 127]; scale per tensor (axis=None)
    or per ``axis`` (reduced over all other axes, kept as size-1 dims)."""
    if axis is None:
        amax = x.abs().max()
    else:
        reduce = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        amax = x.abs().amax(dim=reduce, keepdim=True)
    scale = _scale_of(amax)
    return _codes(x, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_embedding_rows(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weight-only int8 with per-row scales, the scale inlined into the row:
    ``qs`` is (N, E+4) int8, E codes followed by the 4 little-endian bytes of
    the float32 scale, so one gather fetches a row and its scale."""
    scale = _scale_of(table.abs().amax(dim=1, keepdim=True))
    q = _codes(table, scale)
    scale_bytes = scale.to(torch.float32).contiguous().view(torch.int8)   # (N, 4)
    return {"qs": torch.cat([q, scale_bytes], dim=1)}


def unpack_qs(qs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., E+4) int8 packed rows → (values f32 (..., E), scales f32 (..., 1))."""
    e = qs.shape[-1] - 4
    vals = qs[..., :e].to(torch.float32)
    scales = qs[..., e:].contiguous().view(torch.float32)
    return vals, scales


def gather_dequant(qtable: Dict[str, torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """One gather of the packed int8+scale rows, then dequantize."""
    qs = qtable["qs"]
    rows = qs.index_select(0, idx.reshape(-1)).reshape(*idx.shape, qs.shape[1])
    vals, scales = unpack_qs(rows)
    return vals * scales


def float_codes(w_q: torch.Tensor) -> torch.Tensor:
    """The float32 copy of a weight's int8 codes that :func:`exact_int_matmul`
    multiplies by. It holds the same integers, so it is no parameter: a model
    makes it once on its device and keeps it beside the codes."""
    return w_q.to(torch.float32)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor,
                     b_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → exact int32 accumulators (see module doc).
    ``b_f`` is ``float_codes(b)``, kept by the caller; without it the codes
    are converted here."""
    if b_f is None:
        b_f = float_codes(b)
    k = a.shape[1]
    acc = None
    for lo in range(0, k, EXACT_K):
        part = (a[:, lo:lo + EXACT_K].to(torch.float32) @ b_f[lo:lo + EXACT_K]).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, w_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K) int8 @ (K, N) int8 → f32 with int32 accumulation. ``w_scale``
    may be per tensor or per output channel; ``w_f`` as in
    :func:`exact_int_matmul`."""
    acc = exact_int_matmul(x_q, w_q, w_f)
    return acc.to(torch.float32) * x_scale * w_scale.reshape(1, -1)


def quantized_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    b: Optional[torch.Tensor], act_scale: Optional[torch.Tensor] = None,
                    w_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One quantized linear layer: f32 activations → int8 → int8 product → f32.
    ``act_scale=None`` takes the scale from this batch's abs-max (dynamic);
    a fixed scale is static post-training quantization. ``w_f`` is the kept
    ``float_codes(w_q)``."""
    if act_scale is None:
        act_scale = _scale_of(x.abs().max())
    out = int8_matmul(_codes(x, act_scale), w_q, act_scale, w_scale, w_f)
    if b is not None:
        out = out + b
    return out


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return torch.round(x / scale).clamp(-127, 127) * scale

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient: the cotangent
    passes to ``x`` unchanged, clipped values included, and ``scale`` gets
    none. ``scale`` is a tensor, so that ``x / scale`` is a division on every
    device."""
    return _FakeQuant.apply(x, scale)


def fake_quant_per_tensor(x: torch.Tensor) -> torch.Tensor:
    """:func:`fake_quant` with the scale from this tensor's abs-max, taken
    outside the gradient."""
    return fake_quant(x, _scale_of(x.detach().abs().max()))
