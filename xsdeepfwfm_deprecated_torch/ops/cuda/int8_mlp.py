"""Fused int8 deep tower: the Hopper kernel, its plain version and its operand layout.

Replaces the TPU kernel ``_int8_mlp_kernel``
(``xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26-49``); the kernel is
``csrc/int8_mlp.cu``, whose header notes its bound on the card and its
design. For each hidden layer, with the scale over a whole ``block_b``-row
tile: quantize the activations to int8, take the int8×int8→int32 product,
then ``relu((acc·s)·w_scale + b)``; the bias-free head is quantized the same
way. Output (B, 1) f32.

:func:`pack_quantized_deep` lays the weights out for the kernel once, when a
model is prepared for serving: each layer transposed to ``[out][in]`` and
every width zero-padded to one multiple of 32. Zeros change neither an
abs-max nor a sum, so the padded tower computes the same function.
:func:`int8_mlp_reference` is the same function in plain PyTorch on that
layout; :func:`int8_mlp` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..quantized import exact_int_matmul
from . import _build

PAD = 32        # the kernel's K step (mma m16n8k32)
BLOCK_ROWS = 64  # rows of one kernel block; a scale tile holds whole blocks
MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use

Layers = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
Head = Tuple[torch.Tensor, torch.Tensor]


def pack_quantized_deep(deep_q: Dict) -> Tuple[Layers, Head]:
    """(layers_q, fc_q) in the kernel's layout from a ``QuantizedModel``'s
    ``deep_q`` (its ``net_1``): layers_q = ((w_t int8 (W, W) [out][in],
    w_scale f32 (W,), b f32 (W,)), ...), fc_q = (fc int8 (W,), fc_scale f32 (1,))."""
    net = deep_q["net_1"] if "net_1" in deep_q else deep_q
    if net["fc"]["w_q"].shape[1] != 1:
        raise ValueError("the fused tower has a 1-unit head")
    dims = [net["layers"][0]["w_q"].shape[0]] + [l["w_q"].shape[1] for l in net["layers"]]
    width = -(-max(dims) // PAD) * PAD

    def vec(v: torch.Tensor) -> torch.Tensor:
        out = v.new_zeros(width)
        out[:v.numel()] = v.reshape(-1)
        return out

    layers = []
    for layer in net["layers"]:
        w = layer["w_q"]
        w_t = w.new_zeros((width, width))
        w_t[:w.shape[1], :w.shape[0]] = w.T
        layers.append((w_t, vec(layer["w_scale"].to(torch.float32)),
                       vec(layer["b"].to(torch.float32))))
    fc = (vec(net["fc"]["w_q"]), net["fc"]["w_scale"].to(torch.float32).reshape(1).clone())
    return tuple(layers), fc


def _tile_codes(h: torch.Tensor, block_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile scale (T, 1, 1) and int8 codes (B, W) of h (B, W)."""
    b = h.shape[0]
    tiles = h.reshape(b // block_b, block_b, -1)
    s = tiles.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-12) / 127.0
    q = torch.round(tiles / s).clamp(-127, 127).to(torch.int8)
    return s, q.reshape(b, -1)


def int8_mlp_reference(x: torch.Tensor, layers_q: Layers, fc_q: Head,
                       block_b: int = 512) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, IN) f32 → (B, 1) f32.
    The int32 products are exact (:func:`..quantized.exact_int_matmul`)."""
    b = x.shape[0]
    block_b = min(block_b, b)
    if b % block_b:
        raise ValueError(f"batch {b} is not a multiple of block_b {block_b}")
    n_tiles, width = b // block_b, layers_q[0][0].shape[1]
    h = torch.nn.functional.pad(x.to(torch.float32), (0, width - x.shape[1]))
    for w_t, w_scale, bias in layers_q:
        s, q = _tile_codes(h, block_b)
        acc = exact_int_matmul(q, w_t.T).to(torch.float32).reshape(n_tiles, block_b, width)
        h = torch.relu(acc * s * w_scale + bias).reshape(b, width)
    fc, fc_scale = fc_q
    s, q = _tile_codes(h, block_b)
    acc = exact_int_matmul(q, fc.reshape(-1, 1)).to(torch.float32).reshape(n_tiles, block_b, 1)
    return (acc * s * fc_scale).reshape(b, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_mlp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_mlp_forward.argtypes = [
        ptr, i32, i32, i32, i32, i32,
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(ptr),
        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.int8_mlp_forward.restype = i32
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_mlp: {msg}")


def int8_mlp(x: torch.Tensor, layers_q: Layers, fc_q: Head, block_b: int = 512) -> torch.Tensor:
    """x (B, IN) f32 → (B, 1) f32 through the fused int8 tower, with
    ``block_b = min(block_b, B)`` rows per scale tile. A CUDA tensor
    launches the kernel (or raises); a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return int8_mlp_reference(x, layers_q, fc_q, block_b)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    b = x.shape[0]
    block_b = min(block_b, b)
    width = layers_q[0][0].shape[1] if layers_q else 0
    _check(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
           "x must be a contiguous 2-D float32 tensor")
    _check(len(layers_q) >= 1 and width % PAD == 0 and x.shape[1] <= width,
           f"needs >= 1 hidden layer and a width that is a multiple of {PAD} and >= the input")
    _check(b > 0 and b % block_b == 0 and block_b % BLOCK_ROWS == 0,
           f"batch {b} must be a multiple of block_b {block_b}, itself a multiple of {BLOCK_ROWS}")
    # a gemm block holds (BM + BN) rows of (W + ROW_PAD) bytes (csrc/int8_mlp.cu)
    _check((BLOCK_ROWS + 32) * (width + 16) <= MAX_SMEM, f"width {width} too large")
    for w_t, w_scale, bias in layers_q:
        _check(w_t.dtype == torch.int8 and w_t.shape == (width, width)
               and w_scale.dtype == torch.float32 and bias.dtype == torch.float32
               and w_scale.shape == (width,) and bias.shape == (width,),
               "layers_q must come from pack_quantized_deep")
    fc, fc_scale = fc_q
    _check(fc.dtype == torch.int8 and fc.shape == (width,) and fc_scale.dtype == torch.float32,
           "fc_q must come from pack_quantized_deep")
    tensors = [fc, fc_scale] + [t for layer in layers_q for t in layer]
    _check(all(t.device == x.device and t.is_contiguous() for t in tensors),
           "weights must be contiguous and on x's device")

    lib = _lib()
    n = len(layers_q)
    q = torch.empty((b, width), dtype=torch.int8, device=x.device)
    y = torch.empty((b, width), dtype=torch.float32, device=x.device)
    amax = torch.empty(((n + 1) * (b // block_b),), dtype=torch.int32, device=x.device)
    out = torch.empty((b, 1), dtype=torch.float32, device=x.device)
    w_t, w_scale, bias = ((ctypes.c_void_p * n)(*(layer[i].data_ptr() for layer in layers_q))
                          for i in range(3))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.int8_mlp_forward(
            x.data_ptr(), b, x.shape[1], width, n, block_b, w_t, w_scale, bias,
            fc.data_ptr(), fc_scale.data_ptr(), q.data_ptr(), y.data_ptr(),
            amax.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"int8_mlp: CUDA error {rc} at launch")
    int8_mlp.launches += 1
    return out


int8_mlp.launches = 0   # tower launches on the card (each is 2 + 2 * n_hidden kernels)
